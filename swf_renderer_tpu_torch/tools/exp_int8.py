"""Placement on int8 limbs: s8 products on the tensor cores.

    python3 -m swf_renderer_tpu_torch.tools.exp_int8

Port of the reference's ``tools/exp_int8.py``.  Values quantize on the
host to fixed point q = round(v * 2^20) (S = 20, range +-4, quantum
~1e-6, far below the u8 output quantum) and split into three signed
base-256 limbs (``limbs_of``).  The kernel places each 128-slot block
with three s8 x s8 -> s32 products against the step matrix and combines
them into one int32 winding, m0 + (m1 << 8) + (m2 << 16); the resolve
converts the exact integer winding to f32 with one scale.  Integer
accumulation is exact for the quantized values, so nothing rounds until
the u8 quantize; the quantization itself moves pixels of near-zero
coverage against B1 (``render_fused_blocksn``, f32 values).

On the headline scene (60 frames x 4 layers x 1088x1920,
``build_scene_edges`` seed 7, packed by the native grouped packer with
group 6 and one strip a plane) ``main`` times ``run_int8`` with CUDA
events (median of 5 after a warm-up) and prints one JSON line: ms,
Gpx/s, ``matches`` / ``byte_dmax`` against the plain version
(``int8_plain``) and ``matches_b1`` / ``byte_dmax_b1`` against B1; then
the card's name and power limit.  Needs one NVIDIA card and ``nvcc``.

``run_int8`` launches its kernel (``csrc/flatblock.cu``
``swf_fused_int8``) for tensors on the card, runs ``int8_plain`` for
tensors on the CPU, and counts its launches in ``.launches``.  The
reference's limits hold: one strip a plane, the nonzero rule; and the
kernel's: at most 8 placement blocks a group (ValueError otherwise, on
every device).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import flatblock as fb
from ..ops.coverage import FILL_RULE_NONZERO, layer_rules
from ..ops.flatblock import BLK, LANE, STRIP_H
from . import exp_split

S = 20   # fixed-point exponent
GROUP = exp_split.GROUP
pack = exp_split.pack


def limbs_of(vals: np.ndarray):
    """Values -> (l0, l1, l2) int8 limbs of q = round(v * 2^S) (half to
    even, clipped to +-(2^23 - 1)) and the quantized values (l0 + 256 l1
    + 65536 l2) / 2^S in float64, as the reference's ``limbs_of``.  Like
    the reference's assert, refuses (ValueError) values whose top limb
    reaches 127 in magnitude (|v| >= ~7.97)."""
    q = np.round(vals.astype(np.float64) * (1 << S)).astype(np.int64)
    q = np.clip(q, -(1 << 23) + 1, (1 << 23) - 1)
    l0 = ((q + 128) & 255) - 128
    q1 = (q - l0) >> 8
    l1 = ((q1 + 128) & 255) - 128
    l2 = (q1 - l1) >> 8
    if not np.abs(l2).max() < 127:
        raise ValueError("values out of the int8 limbs' range (|v| >= ~7.97)")
    return (l0.astype(np.int8), l1.astype(np.int8), l2.astype(np.int8),
            (l0 + 256.0 * l1 + 65536.0 * l2) / (1 << S))


def limbs_to_device(d):
    """The limbs of ``d["uval"]`` (``pack``'s dict) as three int8 tensors
    of its shape, on its device."""
    l0, l1, l2, _ = limbs_of(d["uval"].cpu().numpy())
    return tuple(torch.from_numpy(x).to(d["uval"].device)
                 for x in (l0, l1, l2))


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _q_winding(sidx, flags, lays, urc, ucm, q, frames: int, layers: int,
               ns1: int, n_chunks: int, group: int):
    """Exact integer winding (F, NS+1, L, plane_rows, 128) int64 of the
    quantized values ``q`` (NG, group*128): each row's in-chunk prefix
    plus the row's sums over earlier chunks."""
    dev = urc.device
    ng = urc.shape[0]
    plane_rows = fb.plane_rows_for(n_chunks)
    nblk = torch.bitwise_right_shift(flags, 2)
    slot = torch.arange(group, device=dev)
    used = (nblk[:, None] == 0) | (slot[None, :] < nblk[:, None])
    f = (sidx // (layers * ns1)).long()
    s = (sidx % ns1).long()
    lay = lays.t().long()
    rc = urc.reshape(ng, group, BLK).long()
    cm = ucm.reshape(ng, group, BLK).long()
    qv = torch.where(used[..., None], q.reshape(ng, group, BLK),
                     torch.zeros((), dtype=torch.int64, device=dev))
    plane_id = (f * ns1 + s)[:, None] * layers + lay
    row_id = (plane_id[..., None] * plane_rows + rc).reshape(-1)
    n_rows = frames * ns1 * layers * plane_rows
    flat = torch.zeros(n_rows * LANE, dtype=torch.int64, device=dev)
    flat.index_add_(0, row_id * LANE + cm.reshape(-1), qv.reshape(-1))
    x = flat.view(frames, ns1, layers, plane_rows, LANE).cumsum(-1)
    tot = x[..., -1]
    nc8 = n_chunks * STRIP_H
    win = tot[..., :nc8].reshape(frames, ns1, layers, n_chunks, STRIP_H)
    carry = torch.zeros_like(tot)
    carry[..., :nc8] = (win.cumsum(-2) - win).reshape(frames, ns1, layers,
                                                      nc8)
    return x + carry[..., None]


def int8_plain(sidx, flags, lays, urc, ucm, l0, l1, l2, colors, frames: int,
               layers: int, n_strips: int, n_chunks: int, group: int):
    """Plain version of ``run_int8`` -> (F, NS+1, 8, n_chunks*128) int32
    words: the exact integer winding of q = l0 + 256 l1 + 65536 l2 to f32
    times 2^-20, then B1's nonzero rule, composite and quantize."""
    q = (l0.long() + 256 * l1.long() + 65536 * l2.long()).reshape(
        urc.shape[0], -1)
    winding = _q_winding(sidx, flags, lays, urc, ucm, q, frames, layers,
                         n_strips + 1, n_chunks, group)
    winding = winding.to(torch.float32) * (1.0 / (1 << S))
    rules = layer_rules(FILL_RULE_NONZERO, layers)
    covs = [fb._fill_cov(winding[:, :, lyr], rules[lyr])
            for lyr in range(layers)]
    colors = colors.to(torch.float32)

    def read_color(lyr, ch):
        return colors[:, lyr, ch][:, None, None, None]

    return fb._strips_to_rows(fb._composite_pack(covs, read_color),
                              n_chunks, 1)


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


def _check_int8(sidx, flags, lays, urc, ucm, l0, l1, l2, colors, frames,
                layers, n_chunks, group):
    ng = sidx.shape[0]
    shape = (ng, 1, group * BLK)
    for name, t in (("l0", l0), ("l1", l1), ("l2", l2)):
        if tuple(t.shape) != shape or t.dtype != torch.int8:
            raise ValueError(f"{name}: expected int8 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    devices = {t.device for t in (l0, l1, l2)}
    # urc stands in uval's place: the limbs replace the values.
    dev = fb._check_inputs(sidx, flags, lays, urc, ucm, urc, colors, frames,
                           layers, group)
    if devices != {dev}:
        raise ValueError(f"limbs on {sorted(map(str, devices))}, inputs on "
                         f"{dev}")
    exp_split.check_product(group, n_chunks)
    return exp_split._device_or_raise(dev)


def run_int8(sidx, flags, lays, urc, ucm, l0, l1, l2, colors, frames: int,
             layers: int, n_strips: int, n_chunks: int, group: int = GROUP):
    """B1 on int8 limbs -> (F, NS+1, 8, n_chunks*128) int32 words
    (counterpart of the reference's ``run_int8``; the sentinel strip block
    NS is left unwritten on the card).

    Kernel: replaces ``_kernel`` (tools/exp_int8.py:53, pallas_call
    :146).  B1's grid and carry (an exact integer sum of q); the
    layer-masked form's body (csrc/place_mma_device.cuh ``product_block``
    at ``kVarInt8``): a group's in-chunk slots form one K run, the layers
    fold into N, and each warpgroup's ``wgmma`` m64nNk32 s8 -> s32
    products take the step matrix from registers and each limb's K-major
    tile from shared memory into one accumulator a limb, combined as m0 +
    (m1 << 8) + (m2 << 16) in wrapping uint32 at the resolve (two passes
    of eight layers at 16).  Bound: bytes (B1's, with 3 B of limbs a slot
    in place of a 4 B value).  Inputs as ``render_fused_blocksn``'s at one
    strip a plane, with the limbs (NG, 1, group*128) int8 of ``limbs_of``
    in place of uval."""
    dev = _check_int8(sidx, flags, lays, urc, ucm, l0, l1, l2, colors,
                      frames, layers, n_chunks, group)
    if dev.type == "cpu":
        return int8_plain(sidx, flags, lays, urc, ucm, l0, l1, l2, colors,
                          frames, layers, n_strips, n_chunks, group)
    from ..ops import cuda_lib

    tensors = (sidx, flags, lays, urc, ucm, l0, l1, l2, colors)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("kernel inputs must be contiguous")
    ns1 = n_strips + 1
    out = torch.empty((frames, ns1, STRIP_H, n_chunks * LANE),
                      dtype=torch.int32, device=dev)
    rules = tuple(int(r) for r in layer_rules(FILL_RULE_NONZERO, layers))
    rules_t, _, _ = fb._device_tables(rules, None, dev)
    sg_index = torch.empty(2 * frames * ns1, dtype=torch.int32, device=dev)
    err = cuda_lib.load().swf_fused_int8(
        *(t.data_ptr() for t in tensors), rules_t.data_ptr(),
        sg_index.data_ptr(), out.data_ptr(), sidx.shape[0], group, frames,
        layers, ns1, n_chunks, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8 product kernel launch failed: CUDA error "
                           f"{err}")
    run_int8.launches += 1
    return out


run_int8.launches = 0


def main() -> None:
    from ..ops.flatblock import render_fused_blocksn
    from ..utils.scenes import build_scene_edges
    from .timing import card_line, time_ms

    if not torch.cuda.is_available():
        raise SystemExit("exp_int8 needs a CUDA card")
    frames, layers, height, width = exp_split.HEADLINE
    tables, colors = build_scene_edges(frames, layers, height, width)
    d = pack(tables, height, width, "cuda")
    limbs = limbs_to_device(d)
    cols = torch.as_tensor(colors, device="cuda")
    ns, nc = d["ns"], d["nc"]
    args = (d["sidx"], d["flags"], d["lays"], d["urc"], d["ucm"], *limbs,
            cols, frames, layers, ns, nc, GROUP)
    b1 = render_fused_blocksn(d["sidx"], d["flags"], d["lays"], d["urc"],
                              d["ucm"], d["uval"], cols, frames, layers, ns,
                              nc, group=GROUP)[:, :ns]
    got = run_int8(*args)[:, :ns]
    want = int8_plain(*args)[:, :ns]
    ms = time_ms(torch, lambda: run_int8(*args))
    print(json.dumps({"kind": "int8", "ms": ms,
                      "gpx_s": frames * height * width / ms / 1e6,
                      "matches": bool(torch.equal(got, want)),
                      "byte_dmax": exp_split.byte_diff(got, want)[0],
                      "matches_b1": bool(torch.equal(got, b1)),
                      "byte_dmax_b1": exp_split.byte_diff(got, b1)[0]}),
          flush=True)
    print(card_line())


if __name__ == "__main__":
    main()
