"""Flash attention (GQA-grouped, causal or full) with its own backward —
plain PyTorch ops.  Counterpart of `repro.models.flash` (``_flash_fwd`` and
the custom-VJP ``_flash_bwd``).

Same algorithm as the reference: a static Python loop over q chunks, an
online-softmax loop over kv chunks, so causal chunk i only visits kv chunks
0..i (the strictly-upper triangle is never computed, in the forward or the
backward); k/v are zero-padded to a kv_chunk multiple and the pad masked
out; ``causal=False`` serves encoder self-attention and cross-attention (kv
length may differ from q length).  The score block stays [.., q_chunk,
kv_chunk], so a long sequence never materializes an S x S score tensor.

Why a backward of its own (`torch.autograd.Function`): autograd through the
online-softmax loop would keep every P block for the backward, O(S^2)
memory again.  The forward saves (q, padded k, padded v, o, lse) — O(S*hd)
— and the backward recomputes P per (q-chunk, kv-chunk) pair from lse, with
``delta = sum(do * o)``.  Cotangents come back in the inputs' dtypes.

Layout: q [B, S, KV, G, hd] (G = query heads per KV group), k/v [B, Sk, KV, hd].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _n_kv_chunks(i: int, q_chunk: int, kv_chunk: int, sq: int, sk: int, causal: bool) -> int:
    if not causal:
        return -(-sk // kv_chunk)
    return -(-min((i + 1) * q_chunk, sk) // kv_chunk)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, q_chunk, kv_chunk, causal):
        sk = k.shape[1]
        k = _pad_kv(k, kv_chunk)
        v = _pad_kv(v, kv_chunk)
        o, lse = _flash_fwd(q, k, v, scale, q_chunk, kv_chunk, causal, sk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (scale, q_chunk, kv_chunk, causal, sk)
        return o

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _flash_bwd(*ctx.args, *ctx.saved_tensors, do)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, scale: float, q_chunk: int = 1024,
                    kv_chunk: int = 1024, causal: bool = True):
    """Grouped attention.  q: [B,S,KV,G,hd]; k,v: [B,Sk,KV,hd].
    Returns [B,S,KV,G,dv]; differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, scale, q_chunk, kv_chunk, causal)


def _pad_kv(x, kv_chunk):
    """Pad the seq axis to a kv_chunk multiple (the reference pads because
    its dynamic slices clamp; here it keeps every kv block full-size)."""
    s = x.shape[1]
    pad = (-s) % kv_chunk
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return x


def _attend_chunk(qi, kj, vj, q0, k0, cq, ck, sk, scale, causal, carry):
    """One online-softmax update.  qi: [B,KV,G,cq,hd], kj/vj: [B,ck,KV,hd]."""
    m, l, acc = carry
    s = torch.einsum("bkgqd,bskd->bkgqs", qi, kj).to(torch.float32) * scale
    kv_pos = k0 + torch.arange(ck, device=qi.device)
    mask = kv_pos[None, :] < sk
    if causal:
        q_pos = q0 + torch.arange(cq, device=qi.device)
        mask = mask & (q_pos[:, None] >= kv_pos[None, :])
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bkgqs,bskd->bkgqd", p.to(vj.dtype), vj
    ).to(torch.float32)
    return m_new, l_new, acc_new


def _flash_fwd(q, k, v, scale, q_chunk, kv_chunk, causal, sk):
    """k, v padded to kv_chunk multiples, ``sk`` their unpadded length.
    Returns (o [B,S,KV,G,dv] in q's dtype, lse [B,KV,G,S] float32)."""
    b, sq, kvh, g, hd = q.shape
    dv = v.shape[-1]
    n_q = -(-sq // q_chunk)
    os, lses = [], []
    for i in range(n_q):
        q0 = i * q_chunk
        cq = min(q_chunk, sq - q0)
        qi = q[:, q0:q0 + cq].permute(0, 2, 3, 1, 4)
        n_kv = _n_kv_chunks(i, q_chunk, kv_chunk, sq, sk, causal)
        carry = (
            torch.full((b, kvh, g, cq), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((b, kvh, g, cq), dtype=torch.float32, device=q.device),
            torch.zeros((b, kvh, g, cq, dv), dtype=torch.float32, device=q.device),
        )
        for j in range(n_kv):
            k0 = j * kv_chunk
            kj = k[:, k0:k0 + kv_chunk]
            vj = v[:, k0:k0 + kv_chunk]
            carry = _attend_chunk(qi, kj, vj, q0, k0, cq, kv_chunk, sk, scale, causal, carry)
        m, l, acc = carry
        o_i = acc / torch.clamp(l, min=1e-30)[..., None]
        lse_i = m + torch.log(torch.clamp(l, min=1e-30))
        os.append(o_i.permute(0, 3, 1, 2, 4).to(q.dtype))   # [B,cq,KV,G,dv]
        lses.append(lse_i)                                    # [B,KV,G,cq]
    o = torch.cat(os, dim=1) if len(os) > 1 else os[0]
    lse = torch.cat(lses, dim=3) if len(lses) > 1 else lses[0]
    return o, lse


def _flash_bwd(scale, q_chunk, kv_chunk, causal, sk, q, k, v, o, lse, do):
    """(dq, dk, dv) of the forward; k, v padded, dk/dv sliced back to ``sk``."""
    b, sq, kvh, g, hd = q.shape
    n_q = -(-sq // q_chunk)
    dq_chunks = []
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(n_q):
        q0 = i * q_chunk
        cq = min(q_chunk, sq - q0)
        qi = q[:, q0:q0 + cq].permute(0, 2, 3, 1, 4)
        doi = do[:, q0:q0 + cq].permute(0, 2, 3, 1, 4)
        oi = o[:, q0:q0 + cq].permute(0, 2, 3, 1, 4)
        lse_i = lse[..., q0:q0 + cq]
        delta = torch.sum(doi.to(torch.float32) * oi.to(torch.float32), dim=-1)  # [B,KV,G,cq]
        qf, dof = qi.to(torch.float32), doi.to(torch.float32)
        dqi = torch.zeros((b, kvh, g, cq, hd), dtype=torch.float32, device=q.device)
        q_pos = q0 + torch.arange(cq, device=q.device)
        for j in range(_n_kv_chunks(i, q_chunk, kv_chunk, sq, sk, causal)):
            k0 = j * kv_chunk
            kj = k[:, k0:k0 + kv_chunk]
            vj = v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bkgqd,bskd->bkgqs", qi, kj).to(torch.float32) * scale
            kv_pos = k0 + torch.arange(kv_chunk, device=q.device)
            mask = kv_pos[None, :] < sk
            if causal:
                mask = mask & (q_pos[:, None] >= kv_pos[None, :])
            p = torch.where(mask, torch.exp(s - lse_i[..., None]), 0.0)
            dp = torch.einsum("bkgqd,bskd->bkgqs", dof, vj.to(torch.float32))
            ds = p * (dp - delta[..., None]) * scale                      # [B,KV,G,cq,ck]
            dqi = dqi + torch.einsum("bkgqs,bskd->bkgqd", ds, kj.to(torch.float32))
            dk[:, k0:k0 + kv_chunk] += torch.einsum("bkgqs,bkgqd->bskd", ds, qf)
            dv[:, k0:k0 + kv_chunk] += torch.einsum("bkgqs,bkgqd->bskd", p, dof)
        dq_chunks.append(dqi.permute(0, 3, 1, 2, 4))
    dq = torch.cat(dq_chunks, dim=1) if len(dq_chunks) > 1 else dq_chunks[0]
    # k/v were padded in the forward; cotangents match the ORIGINAL length
    return dq.to(q.dtype), dk[:, :sk].to(k.dtype), dv[:, :sk].to(v.dtype)
