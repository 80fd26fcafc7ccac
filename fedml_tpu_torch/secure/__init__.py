"""Secure aggregation (port of ``fedml_tpu/secure``): the finite-field MPC
toolbox, pairwise masking in the uint32 ring, and its fused CUDA kernel.
The live SecAgg protocol over the cross-silo wire (``secure/protocol.py``)
is not ported yet."""

from fedml_tpu_torch.secure.field import (  # noqa: F401
    P_DEFAULT, additive_shares, bgw_decode, bgw_encode, key_agreement,
    lagrange_coeffs, lcc_decode, lcc_decode_with_points, lcc_encode,
    lcc_encode_with_points, mod_div, mod_inv, pk_gen, prod_mod)
from fedml_tpu_torch.secure.fused_mask import (  # noqa: F401
    quantize_mask, quantize_mask_plain)
from fedml_tpu_torch.secure.secagg import (  # noqa: F401
    RING_CAPACITY, SecureCohortAggregator, dequantize, pairwise_masks,
    quantize, ring_budget_scale, ring_sum, validate_ring_budget)
