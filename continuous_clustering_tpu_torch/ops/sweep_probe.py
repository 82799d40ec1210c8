"""The CC sweep's building blocks, one probe variant each: the counterpart of
``scripts/pallas_bisect.py::probe`` (kernels ``k0``-``k6``), a lowering
bisection of the TPU sweep kernel that no path of the system reaches.

Every variant takes ``bits`` (H+1, 2, R, B) i32 (K1's edge words), ``upper``
() i32 (the column-offset bound) and ``L`` (R, WCOL) i32 labels, WCOL = H + B,
and returns (R, WCOL) i32.  They work on ``lpad``, the labels inside a
scratch of (R + 2V, PW) cells, PW = WCOL + 2H rounded up to 128 lanes, with
``INF = R * WCOL`` around them, and on lane rolls of its row bands:
``roll(a, s)`` moves elements to higher lanes (``torch.roll``), modulo PW.

=======================  ================================================
variant (script name)    computes
=======================  ================================================
``V0_init_copy``         L, through the padded scratch
``V1_static_slice_roll`` min(L, the band 3 - V rows away rolled by 5)
``V2_dynamic_roll``      ``upper`` rounds of that with roll ``dc``, in place
``V3_bool_mask``,        for dc < upper and dr_idx in (0, 17, 34): min with
``V3i_i32_mask``         the band ``dr_idx - V`` rows away rolled by dc,
                         where bit ``dr_idx % 32`` of word 0 of bits[dc] is
                         set; bool and i32 masks, the same function
``V4_mask_scratch``      pull-right: that mask written into a second scratch
                         at lane offset 2H, both rolled by -dc
``V5_cmp_astype_prefix`` f32 compares -> i32 -> a running prefix product
                         over three row bands, per dc
``V6_bitpack``           three f32 compares packed into a word (zero
                         padding), written to the second scratch
=======================  ================================================

The wrapper rule of the port: a CUDA tensor launches the kernel
(``csrc/sweep_probe.cu``: one block on one SM, each thread owning the same
<= 5 cells in every step, the labels in registers and in shared memory
twice, the mask bits unpacked into shared memory before the first step) or
raises; a CPU tensor takes the plain twin.  Each launch is counted in
``utils/stats.LAUNCHES``.
"""

from __future__ import annotations

import torch

from ..utils.stats import LAUNCHES
from .cc_cuda import check_tensor, load_kernels, raise_on_error

# the script's module constants
H, V, R, B = 20, 20, 32, 128
# script name -> kernel variant id (V3 and V3i share one body on the card)
VARIANTS = {
    "V0_init_copy": 0, "V1_static_slice_roll": 1, "V2_dynamic_roll": 2, "V3_bool_mask": 3,
    "V3i_i32_mask": 4, "V4_mask_scratch": 5, "V5_cmp_astype_prefix": 6, "V6_bitpack": 7,
}
DR_IDX = (0, 17, 34)        # range(0, 2V + 1, 17) at V = 20


def padded_width(H: int, WCOL: int) -> int:
    return -(-(WCOL + 2 * H) // 128) * 128


def sweep_probe(name: str, bits: torch.Tensor, upper: torch.Tensor, L: torch.Tensor,
                *, V: int = V) -> torch.Tensor:
    """Run probe variant ``name`` (a key of ``VARIANTS``)."""
    if name not in VARIANTS:
        raise ValueError(f"unknown probe variant {name!r}")
    if L.device.type == "cpu":
        return sweep_probe_reference(name, bits, upper, L, V=V)
    if L.device.type != "cuda":
        raise ValueError(f"sweep_probe: unsupported device {L.device}")
    nd, _, R_, B_ = bits.shape
    H_ = nd - 1
    WCOL = H_ + B_
    dev = L.device
    check_tensor(bits, "bits", torch.int32, (H_ + 1, 2, R_, B_), dev)
    check_tensor(L, "L", torch.int32, (R_, WCOL), dev)
    upper = upper.reshape(1)
    check_tensor(upper, "upper", torch.int32, (1,), dev)
    out = torch.empty_like(L)
    lib = load_kernels()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cct_sweep_probe(VARIANTS[name], bits.data_ptr(), upper.data_ptr(),
                                  L.data_ptr(), out.data_ptr(), R_, B_, H_, V,
                                  padded_width(H_, WCOL), stream)
    raise_on_error(err, "sweep_probe")
    LAUNCHES["sweep_probe"] += 1
    return out


def sweep_probe_reference(name: str, bits: torch.Tensor, upper: torch.Tensor, L: torch.Tensor,
                          *, V: int = V) -> torch.Tensor:
    """Plain PyTorch twin of every variant: the scratch as a tensor, the
    script's loops as Python loops."""
    nd, _, R_, B_ = bits.shape
    H_ = nd - 1
    WCOL = H_ + B_
    PW = padded_width(H_, WCOL)
    inf = R_ * WCOL
    n_up = int(upper)
    variant = VARIANTS[name]

    def scratch(fill):
        pad = torch.full((R_ + 2 * V, PW), fill, dtype=torch.int32, device=L.device)
        pad[V:V + R_, H_:H_ + WCOL] = L
        return pad

    def band(pad, row0, shift):  # roll(pad[row0:row0 + R], shift)[:, H:H + WCOL]
        return torch.roll(pad[row0:row0 + R_], shift, dims=1)[:, H_:H_ + WCOL]

    def masks(dc):  # bit dr_idx % 32 of word 0 of bits[dc], (R, B) i32
        return [(bits[dc, 0] >> (k % 32)) & 1 for k in DR_IDX]

    lpad = scratch(inf)
    center = lpad[V:V + R_, H_:H_ + WCOL]       # a view: updates land in lpad
    if variant == 0:
        return center.clone()
    if variant == 1:
        return torch.minimum(center, band(lpad, 3, 5))
    if variant == 7:
        # the mask scratch is rewritten whole at every dc, so the output is
        # the last dc's word (zeros when upper = 0)
        out = torch.zeros_like(L)
        if n_up > 0:
            zpad = scratch(0)
            for k in range(3):
                nb = band(zpad, k, n_up - 1)
                out |= (torch.abs(nb.to(torch.float32)) < 5.0).to(torch.int32) << k
        return out
    mpad = torch.zeros_like(lpad)
    for dc in range(n_up):
        if variant == 2:
            center.copy_(torch.minimum(center, band(lpad, 3, dc)))
        elif variant in (3, 4):
            halo = torch.zeros((R_, H_), dtype=torch.int32, device=L.device)
            for dr_idx, m in zip(DR_IDX, masks(dc)):
                mfull = torch.cat([halo, m], 1)
                nb = band(lpad, dr_idx, dc)
                center.copy_(torch.minimum(center, torch.where(mfull == 1, nb, inf)))
        elif variant == 5:
            for dr_idx, m in zip(DR_IDX, masks(dc)):
                mpad[V:V + R_, 2 * H_:2 * H_ + B_] = m
                src = band(lpad, 2 * V - dr_idx, -dc)
                ms = band(mpad, 2 * V - dr_idx, -dc)
                center.copy_(torch.minimum(center, torch.where(ms == 1, src, inf)))
        elif variant == 6:
            cur = center.clone()
            acc = (~(torch.abs(cur.to(torch.float32) - 3.0) > 1.5)).to(torch.int32)
            for k in range(3):
                nb = band(lpad, k, dc)
                acc = acc * (~(torch.abs(nb.to(torch.float32)) > 2.0)).to(torch.int32)
                cur = torch.minimum(cur, torch.where(acc == 1, nb, inf))
            center.copy_(cur)
    return center.clone()
