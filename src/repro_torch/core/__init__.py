"""Core: the paper's contributions as composable PyTorch functions."""
from repro_torch.core.ternary import (
    clamp_threshold,
    pack_ternary,
    packed_nbytes,
    select_decode,
    select_masks,
    sparsity,
    ste_ternary_acts,
    ste_ternary_weights,
    ternary_quantize_acts,
    ternary_quantize_weights,
    unpack_ternary,
)
from repro_torch.core.tcn import (
    StreamState,
    TCNStream,
    conv2d_undilated,
    dilated1d_via_2d,
    dilated_causal_conv1d,
    project_weights_to_2d,
    receptive_field,
    stream_tcn_apply,
    unwrap_time_axis,
    wrap_time_axis,
)
