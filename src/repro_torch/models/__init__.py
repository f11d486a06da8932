"""`repro_torch.models` — the legacy CUTIE network shim (`cutie_net`).
The reference's LM scaffold under `repro.models` is not ported."""
