"""TCN extensions — the paper's §4, in PyTorch.  Counterpart of
`repro.core.tcn`.

1. ``dilated_causal_conv1d`` — the reference semantics, Eq. (1):

       (w * x)[n] = sum_{k=1..N}  x~[n - (k-1)·D] · w[N-k]

2. ``dilated1d_via_2d`` — the paper's mapping of a dilated 1-D convolution
   to an *undilated* 2-D convolution (Eq. 2 / Fig. 3):

       z[q, m] = x~[q·D + m]            (wrap the time axis modulo D)
       (w * x)[n] = sum_k z[q-(k-1), m] · w[N-k],   n = q·D + m

   The 1-D kernel is projected into the middle column of a KH x KW kernel,
   so the 2-D engine (the fused conv kernel) executes TCN layers unchanged.

3. ``TCNStream`` — the TCN memory as a ring buffer with a device-resident
   write cursor, and ``StreamState`` (ring + monotonic frame counter).

Shapes: x is [B, T, C_in]; 1-D weights are [N, C_in, C_out] (tap k=0 is
the oldest tap).  2-D layouts are the reference's: NHWC activations,
[KH, KW, C_in, C_out] weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, pad) -> torch.Tensor:
    """Stride-1 cross-correlation in the reference's layouts: x [B,H,W,C],
    w [KH,KW,C_in,C_out], ``pad`` = (top, bottom, left, right) zeros."""
    top, bottom, left, right = pad
    xn = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    y = F.conv2d(xn, w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


# ---------------------------------------------------------------------------
# Reference: Eq. (1)
# ---------------------------------------------------------------------------

def dilated_causal_conv1d(x: torch.Tensor, w: torch.Tensor, dilation: int) -> torch.Tensor:
    """Causal dilated 1-D convolution, the literal Eq. (1).

    x: [B, T, C_in], w: [N, C_in, C_out] -> [B, T, C_out].
    """
    n_taps = w.shape[0]
    pad = (n_taps - 1) * dilation
    # F.conv1d is a cross-correlation: y[n] = sum_j x[n - pad + j*D] w[j];
    # with pad = (N-1)*D and k = N - j this is exactly Eq. (1).
    xn = F.pad(x.permute(0, 2, 1), (pad, 0))
    y = F.conv1d(xn, w.permute(2, 1, 0), dilation=dilation)
    return y.permute(0, 2, 1).contiguous()


def receptive_field(n_taps: int, dilations) -> int:
    """f = 1 + sum_i (N-1) * D_i  (paper's receptive-field formula)."""
    return 1 + sum((n_taps - 1) * d for d in dilations)


# ---------------------------------------------------------------------------
# The mapping: dilated 1-D  ->  undilated 2-D (Eq. 2 / Fig. 3)
# ---------------------------------------------------------------------------

def wrap_time_axis(x: torch.Tensor, dilation: int) -> torch.Tensor:
    """z[b, q, m, c] = x~[b, q*D + m, c] — the offline input transform.
    Pads T up to a multiple of D with zeros.  [B,T,C] -> [B, ceil(T/D), D, C]."""
    b, t, c = x.shape
    t_pad = -(-t // dilation) * dilation
    if t_pad != t:
        x = F.pad(x, (0, 0, 0, t_pad - t))
    return x.reshape(b, t_pad // dilation, dilation, c)


def project_weights_to_2d(w: torch.Tensor, kh: int = 3, kw: int = 3) -> torch.Tensor:
    """Project the 1-D kernel [N, C_in, C_out] into the middle column of a
    [KH, KW, C_in, C_out] 2-D kernel (other entries zero); the taps occupy
    the *bottom* N rows in original order (causal row padding (KH-1, 0))."""
    n_taps, c_in, c_out = w.shape
    if n_taps > kh:
        raise ValueError(f"kernel taps {n_taps} exceed 2-D kernel height {kh}")
    k2d = torch.zeros((kh, kw, c_in, c_out), dtype=w.dtype, device=w.device)
    k2d[kh - n_taps:, kw // 2] = w
    return k2d


def conv2d_undilated(z: torch.Tensor, k2d: torch.Tensor) -> torch.Tensor:
    """The undilated 2-D convolution the engine runs: causal on the row (q)
    axis — pad (KH-1, 0); zero 'same' pad on the column (phase) axis."""
    kh, kw = k2d.shape[0], k2d.shape[1]
    return conv2d_nhwc(z, k2d, (kh - 1, 0, kw // 2, kw // 2))


def unwrap_time_axis(y2d: torch.Tensor, t: int) -> torch.Tensor:
    """[B, Q, D, C] -> [B, T, C], inverse of wrap_time_axis (drop tail pad)."""
    b, q, d, c = y2d.shape
    return y2d.reshape(b, q * d, c)[:, :t, :]


def dilated1d_via_2d(
    x: torch.Tensor, w: torch.Tensor, dilation: int, *, kh: int = 3, kw: int = 3
) -> torch.Tensor:
    """End-to-end mapped path: MUST equal dilated_causal_conv1d."""
    t = x.shape[1]
    z = wrap_time_axis(x, dilation)
    k2d = project_weights_to_2d(w, kh=kh, kw=kw)
    return unwrap_time_axis(conv2d_undilated(z, k2d), t)


# ---------------------------------------------------------------------------
# TCN memory — streaming ring buffer (the 576-byte shift register)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TCNStream:
    """Ring-buffer state holding the last ``T`` feature vectors.

    ``buf`` is [T, C] (or [B, T, C]); ``cursor`` is a 0-d int64 tensor on
    the same device (the next write slot), so a push never waits for the
    device.  ``push`` keeps the reference's value semantics: it returns a
    NEW ring and leaves this one untouched (one [T, C] clone per step), so
    an exported state never aliases a session that keeps stepping.  Nothing
    here writes in place.
    """

    buf: torch.Tensor     # [..., T, C]
    cursor: torch.Tensor  # int64 scalar — next write slot

    @staticmethod
    def create(
        n_steps: int, channels: int, batch: Optional[int] = None,
        dtype=torch.float32, device="cuda",
    ) -> "TCNStream":
        shape = (n_steps, channels) if batch is None else (batch, n_steps, channels)
        return TCNStream(
            buf=torch.zeros(shape, dtype=dtype, device=device),
            cursor=torch.zeros((), dtype=torch.int64, device=device),
        )

    @property
    def n_steps(self) -> int:
        return self.buf.shape[-2]

    def push(self, v: torch.Tensor) -> "TCNStream":
        """Insert one feature vector ([..., C]) at the cursor, advance."""
        v = v.to(self.buf.dtype)
        if v.ndim != self.buf.ndim:  # [..., C] -> [..., 1, C]; a [1, C] row is taken as is
            v = v.unsqueeze(-2)
        buf = self.buf.index_copy(-2, self.cursor.reshape(1), v)
        return TCNStream(buf=buf, cursor=(self.cursor + 1) % self.n_steps)

    def ordered(self) -> torch.Tensor:
        """Time-ordered view, oldest first — what the TCN layers consume."""
        t = self.n_steps
        idx = (torch.arange(t, device=self.buf.device) + self.cursor) % t
        return self.buf.index_select(-2, idx)


@dataclasses.dataclass
class StreamState:
    """One stream's complete streaming state: the TCN ring plus a monotonic
    frame counter (a 0-d int64 tensor; the cursor alone loses the age once
    it wraps).  `StreamSession` holds exactly this; a serving-pool slot is
    this with a leading pool axis (`repro_torch.serving.masking`)."""

    ring: TCNStream
    steps_seen: torch.Tensor  # int64 scalar, monotonic across cursor wraps

    @staticmethod
    def create(
        n_steps: int, channels: int, batch: Optional[int] = None,
        dtype=torch.float32, device="cuda",
    ) -> "StreamState":
        return StreamState(
            ring=TCNStream.create(n_steps, channels, batch=batch, dtype=dtype,
                                  device=device),
            steps_seen=torch.zeros((), dtype=torch.int64, device=device),
        )
