"""Winograd F(2x2, 3x3) convolution (3x3, stride 1, SAME) of the PyTorch
port: the kernel op ``winograd_call`` in every mode the flagship's train
chain runs, its plain version, and the chain's three differentiable ops.

Port of ``yolov3_tensorflow_tpu/ops/winograd.py`` on NCHW tensors (the
TPU kernel's [H, W, C, N] view is a TPU tiling choice and is dropped):

  * :func:`winograd_call`: the fused conv with a prologue on the input
    read, an optional aux write of the prologue result, and an epilogue
    on the output write (JAX ``winograd_call`` / ``_kernel``).  Ported
    modes, as (prologue, epilogue):

      PRO_NONE   + EPI_NONE     conv3x3 (tests)
      PRO_NONE   + EPI_STATS    hconv_stats forward
      PRO_BN_ACT + EPI_STATS    hconv_bn_act_stats forward (aux z)
      PRO_BN_ADD + EPI_STATS    hconv_bn_add_act_stats forward (aux a)
      PRO_DYEFF  + EPI_NONE     hconv_stats input gradient (aux dye)
      PRO_DYEFF  + EPI_BN_ACT   hconv_bn_act_stats input gradient (aux)
      PRO_DYEFF  + EPI_BN_ADD   hconv_bn_add_act_stats input gradient
                                (aux dye, out3 the identity's gradient)

    The other pairs, which the JAX package never calls, raise.
  * :func:`hconv_stats`, :func:`hconv_bn_act_stats`,
    :func:`hconv_bn_add_act_stats`: ``torch.autograd.Function``s of the
    JAX custom VJPs; the weight gradient runs on the library's
    convolution in bf16, as the JAX package leaves it to XLA.
  * :func:`eligible`: the JAX package's shape rules, its v5e VMEM budget
    included, so the port routes exactly the convs JAX routes.

The arithmetic, in the kernel's order (JAX ``_kernel``):

  1. prologue per input element: PRO_BN_ACT ``relu(bf16(bf16(x * inv_b)
     + shift_b))`` with ``inv_b = bf16(inv)``; PRO_BN_ADD, the residual
     boundary, ``relu(bf16(bf16(bf16(x * inv_b) + shift_b) + id))`` with
     the identity ``id`` read at the same positions; PRO_DYEFF ``bf16((dy
     + ds) + (2 * dq) * y)`` in float32; the result outside the image is 0
     (the conv consumes the zero-padded prologue output);
  2. input transform ``V = BT d BT^T`` of each 4x4 patch (rows 2t-1 ..
     2t+2): BT's row combos then its column combos, each add rounded to
     bf16;
  3. 16 products ``M[k] = V[k] @ U[k]`` over the input channels, bf16
     operands, float32 sums (``U = G w G^T``, float32, rounded to bf16);
  4. output transform ``AT M AT`` in float32 (row stage, column stage);
  5. epilogue on the unrounded float32 output ``o`` of the positions
     inside the image: EPI_STATS the per-channel (sum o, sum o*o);
     EPI_BN_ACT, the backward of a PRO_BN_ACT conv, ``g = o`` where
     ``bf16(bf16(c * inv_b) + shift_b) > 0`` (``c`` the forward input),
     else 0, the sums (sum g, sum g*c), and the output ``g * inv``;
     EPI_BN_ADD, the backward of a PRO_BN_ADD conv, ``g = o + d`` where
     the boundary activation ``a > 0`` (``d`` the activation's own
     cotangent), else 0, the sums (sum g, sum g*c), the output ``g *
     inv`` and the second output ``out3 = g``;
  6. one bf16 rounding on each store.

On a CUDA tensor :func:`winograd_call` launches the hand-written kernel
(``csrc/winograd.cu``) through its mode's launcher in :data:`KERNELS`,
which counts the launch in its ``.launches``; on a CPU tensor it runs
:func:`winograd_reference`.  There is no fallback: another device, a
failed build or a failed launch raises.  The kernel's f32 sums run in
another order than the plain version's, so the two agree to float32
rounding, and a bf16 output to one bf16 step; the aux output is
bit-equal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import check_launch, kernel_library

# 1D transform matrices of F(2,3) (JAX winograd.py:75-84)
BT = np.array([[1, 0, -1, 0],
               [0, 1, 1, 0],
               [0, -1, 1, 0],
               [0, 1, 0, -1]], np.float32)
G = np.array([[1, 0, 0],
              [0.5, 0.5, 0.5],
              [0.5, -0.5, 0.5],
              [0, 0, 1]], np.float32)
AT = np.array([[1, 1, 1, 0],
               [0, 1, -1, -1]], np.float32)

# prologue modes
PRO_NONE, PRO_BN_ACT, PRO_BN_ADD, PRO_DYEFF = 0, 1, 2, 3
# epilogue modes
EPI_NONE, EPI_STATS, EPI_BN_ACT, EPI_BN_ADD = 0, 1, 2, 3
# the ported (prologue, epilogue) pairs, by the name of their launch count
MODES = {(PRO_NONE, EPI_NONE): "conv",
         (PRO_NONE, EPI_STATS): "conv_stats",
         (PRO_BN_ACT, EPI_STATS): "bn_act_conv_stats",
         (PRO_BN_ADD, EPI_STATS): "bn_add_conv_stats",
         (PRO_DYEFF, EPI_NONE): "dyeff_conv",
         (PRO_DYEFF, EPI_BN_ACT): "dyeff_conv_bn_act",
         (PRO_DYEFF, EPI_BN_ADD): "dyeff_conv_bn_add"}

# ------------------------------------------------------- eligibility --
# The JAX package's VMEM budget for the TPU v5e (winograd.py:86-93), kept
# as a pure shape rule so that the port routes the same convs as JAX.
_VMEM_BUDGET = 45e6
RB = 4  # output tile-rows per TPU grid step


def _pad(v, m):
    return -(-v // m) * m


def _vmem_estimate(wb, C, Co, N, full_streams=1, main_streams=0, aux=0):
    """The JAX kernel's padded-tile VMEM footprint (winograd.py:113-134):
    lanes pad to 128, bf16 sublanes to 16, f32 sublanes to 8; streamed
    blocks are double-buffered."""
    n = _pad(N, 128)
    cb = _pad(C, 16)
    cob = _pad(Co, 16)
    rows_in = 2 * RB + 4
    xin = 2 * rows_in * wb * cb * n * 2
    halo = 2 * 2 * rows_in * cb * n * 2
    out = 2 * (2 * RB) * wb * cob * n * 2
    cmain = 2 * (2 * RB) * wb * cob * n * 2
    auxw = 2 * (2 * RB) * wb * cb * n * 2
    vals = 10 * (wb // 2) * _pad(Co, 8) * n * 4
    u = 2 * 16 * cb * _pad(Co, 128) * 2
    return (full_streams * (xin + halo) + main_streams * cmain
            + aux * auxw + out + vals + u)


def pick_wchunk(W, C, Co, N, full_streams=1, main_streams=0, aux=0):
    """The JAX kernel's W chunk (winograd.py:137-150): the largest even
    chunk within the budget, or None."""
    for wb in range(_pad(W, 2), 5, -2):
        if _vmem_estimate(wb, C, Co, N, full_streams, main_streams,
                          aux) <= _VMEM_BUDGET:
            return wb
    return None


def eligible(shape_nhwc, co, kernel_size, strides, padding,
             feature_group_count, device_type: str = "cpu") -> bool:
    """Can this conv run on the Winograd kernel?  The JAX package's rule
    (winograd.py:153-180): 3x3, stride 1, SAME, ungrouped, H and W >= 2,
    C and Co multiples of 8, and the worst-case forward and backward
    kernels within the v5e budget; a batch below 32 is refused on a
    device (``device_type`` other than "cpu"), as JAX refuses it on a
    backend other than the CPU."""
    if tuple(kernel_size) != (3, 3) or tuple(strides) != (1, 1):
        return False
    if not isinstance(padding, str) or padding.upper() != "SAME":
        return False
    if feature_group_count != 1:
        return False
    n, h, w, c = shape_nhwc
    if h < 2 or w < 2 or c % 8 != 0 or co % 8 != 0:
        return False
    if n < 32 and device_type != "cpu":
        return False
    fwd_ok = pick_wchunk(w, c, co, n, full_streams=2, aux=1) is not None
    bwd_ok = pick_wchunk(w, co, c, n, full_streams=2, main_streams=4,
                         aux=1) is not None
    return fwd_ok and bwd_ok


# --------------------------------------------------- launch geometry --
# The kernel's block (csrc/winograd.cu): at most TILES_PER_BLOCK 2x2
# output tiles (wgmma's M) of one image, whole tile rows where a row has
# at most that many tiles, else a column segment of one row, and
# CO_BLOCK output channels.
TILES_PER_BLOCK = 64
CO_BLOCK = 64
MAX_SMEM_BYTES = 232448  # a block's shared memory on an H100
STAGES = 2  # the staging ring's chunks of input channels


class WinogradPlan(NamedTuple):
    """Launch geometry of one kernel call (:func:`winograd_plan`).

    Block ``b`` of the 1-D grid is co-block ``b % co_blocks``, then column
    segment, tile-row band and image in that order (:meth:`block`).  Band
    ``i`` of an image holds tile rows ``i * rows .. i * rows + rows - 1``
    (fewer in the last band) and stages the input rows ``row0 ..
    row0 + nrows - 1`` (:meth:`band_rows`), which start on an even row.
    ``aligned`` selects the 16-byte-copy variant; ``partial_rows`` is the
    number of partial-sum rows, one per block of tiles (each co-block
    writes its own channels of its row)."""
    n: int
    c: int
    co: int
    h: int
    w: int
    th: int            # tile rows, ceil(h / 2)
    tw: int            # tile columns, ceil(w / 2)
    rows: int          # tile rows per band (R)
    seg_tiles: int     # tile columns per column segment (TWb)
    segs: int          # column segments per band
    bands: int         # bands per image
    co_blocks: int
    cch: int           # input channels per staging chunk
    smem_bytes: int
    aligned: bool
    grid: int
    partial_rows: int

    def band_rows(self, band: int) -> Tuple[int, int]:
        """(first row, row count) of the input rows band ``band`` stages:
        rows 2*tr0 - 2 .. 2*tr0 + 2*R of its tile rows tr0 .. tr0+R-1,
        clipped to the image."""
        tr0 = band * self.rows
        rb = min(self.rows, self.th - tr0)
        row0 = max(2 * tr0 - 2, 0)
        return row0, min(2 * tr0 + 2 * rb + 1, self.h) - row0

    def block(self, b):
        """(image, first tile row, tile rows, first tile column, tile
        columns, co-block) of block ``b`` (an int or an integer array), as
        the kernel decodes it."""
        cb, rest = b % self.co_blocks, b // self.co_blocks
        seg, rest = rest % self.segs, rest // self.segs
        band, n = rest % self.bands, rest // self.bands
        tr0, tc0 = band * self.rows, seg * self.seg_tiles
        return (n, tr0, np.minimum(self.rows, self.th - tr0), tc0,
                np.minimum(self.seg_tiles, self.tw - tc0), cb)


def _u_run_bytes(c):
    """One position's V (or U) buffer, and U_k's run in the laid-out U."""
    return TILES_PER_BLOCK * _pad(c, 16) * 2 + 128


def _region_floor(c, w, rows, seg_tiles, epi_inputs):
    """The shared memory the staging ring shares with the two V and two
    U buffers (later the block's f32 outputs) and, past them, the staged
    rows of the epilogue's epi_inputs tensors."""
    return (max(4 * _u_run_bytes(c), CO_BLOCK * 2 * rows * 2 * seg_tiles * 4)
            + epi_inputs * CO_BLOCK * _pad(2 * rows * w, 8) * 2)


def _smem_bytes(c, w, h, rows, seg_tiles, cch, partner, epi_inputs):
    """The kernel's shared memory: the z band, then the staging ring of x
    (and the partner) or, after it, V and U (two buffers each, later the
    f32 outputs) and the staged epilogue inputs, then the prologue's
    scalars and three mbarriers."""
    run_p = _pad(min(2 * rows + 3, h) * w, 8)
    z = (2 * rows + 2) * (2 * seg_tiles + 2) * c * 2
    stage = STAGES * (2 if partner else 1) * cch * run_p * 2
    return (z + max(_region_floor(c, w, rows, seg_tiles, epi_inputs), stage)
            + 8 * c + 32)


def _chunk_channels(c, w, h, rows, seg_tiles, partner, epi_inputs):
    """Input channels per staging chunk: as many as the shared memory left
    beside the rest of the block holds (a multiple of 8, at least 8, at
    most C rounded up to 8)."""
    run_p = _pad(min(2 * rows + 3, h) * w, 8)
    per_channel = STAGES * (2 if partner else 1) * run_p * 2
    rest = _smem_bytes(c, w, h, rows, seg_tiles, 0, partner, epi_inputs)
    fit = max(0, MAX_SMEM_BYTES - rest + _region_floor(
        c, w, rows, seg_tiles, epi_inputs)) // per_channel
    return min(_pad(c, 8), max(8, fit // 8 * 8))


def winograd_plan(n, c, co, h, w, partner=False,
                  epi_inputs=0) -> WinogradPlan:
    """The kernel's launch geometry for x [n, c, h, w] -> co channels
    (``partner``: the prologue reads a second input; ``epi_inputs``: the
    epilogue reads 0, 1 or 3 tensors of the output's shape).  Bands as
    tall as the 64-tile block and shared memory allow; a row of more than
    64 tiles is cut into equal column segments.  The 16-byte-copy variant
    where the (n, c) plane and every band's first row start on 16 bytes
    (x itself on 16 bytes: the launcher checks)."""
    th, tw = -(-h // 2), -(-w // 2)
    co_blocks = -(-co // CO_BLOCK)
    for segs in range(-(-tw // TILES_PER_BLOCK), tw + 1):
        seg_tiles = -(-tw // segs)
        if -(-tw // seg_tiles) != segs:
            continue  # the same split as a smaller segs
        for rows in range(min(TILES_PER_BLOCK // seg_tiles, th), 0, -1):
            cch = _chunk_channels(c, w, h, rows, seg_tiles, partner,
                                  epi_inputs)
            smem = _smem_bytes(c, w, h, rows, seg_tiles, cch, partner,
                               epi_inputs)
            if smem > MAX_SMEM_BYTES:
                continue
            bands = -(-th // rows)
            starts = {max(2 * b * rows - 2, 0) for b in range(bands)}
            aligned = (h * w * 2) % 16 == 0 and all(
                (s * w * 2) % 16 == 0 for s in starts)
            return WinogradPlan(n, c, co, h, w, th, tw, rows, seg_tiles,
                                segs, bands, co_blocks, cch, smem, aligned,
                                n * bands * segs * co_blocks,
                                n * bands * segs)
    raise ValueError(f"winograd_plan: no block of the kernel fits x "
                     f"{(n, c, h, w)} -> {co} channels in shared memory")


# ----------------------------------------------------------- weights --
def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``w`` [Co, C, 3, 3] -> float32 ``U`` [16, C, Co], U[4i+j] =
    (G w G^T)[i, j] per (C, Co): the rows first, then the columns, as JAX
    does it (winograd.py:105-110)."""
    g = torch.as_tensor(G, device=w.device)
    u = torch.einsum("ia,ocab->iocb", g, w.float())
    u = torch.einsum("iocb,jb->ijco", u, g)
    return u.reshape(16, w.shape[1], w.shape[0])


def _rot_u(w: torch.Tensor) -> torch.Tensor:
    """bf16 ``U`` of the input-gradient conv: w rotated by 180 degrees,
    its in and out channels swapped (JAX ``_rot_u``)."""
    return transform_weights(w.flip(2, 3).transpose(0, 1)).to(
        torch.bfloat16)


def _scal(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two per-channel vectors as the float32 [2, C] scalar operand."""
    return torch.stack([a, b]).float()


# ----------------------------------------------------- plain version --
def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _relu_bf16(t: torch.Tensor) -> torch.Tensor:
    """max(0, t) with NaN propagating and +0 for a -0 input
    (``jnp.maximum(t, 0)``)."""
    return torch.maximum(torch.zeros_like(t), t)


def _prologue(x, partner, scal, scal2, pro):
    """The prologue result, bf16 [N, C, H, W]."""
    if pro in (PRO_BN_ACT, PRO_BN_ADD):
        t = x * _per_channel(scal[0].to(torch.bfloat16))
        t = t + _per_channel(scal[1].to(torch.bfloat16))
        # the residual boundary adds the identity after the apply
        return _relu_bf16(t + partner if pro == PRO_BN_ADD else t)
    if pro == PRO_DYEFF:
        t = x.float() + _per_channel(scal2[0])
        return (t + _per_channel(2.0 * scal2[1]) * partner.float()).to(
            torch.bfloat16)
    return x


def _combo(coefs, terms):
    """sum(coef * term) over the nonzero +-1 coefficients, left to right,
    in the terms' dtype (the kernel's BT combos, JAX winograd.py:331-352)."""
    v = None
    for coef, t in zip(coefs, terms):
        if coef == 0:
            continue
        if v is None:
            v = t if coef > 0 else -t
        else:
            v = v + t if coef > 0 else v - t
    return v


def winograd_reference(x, u, partner=None, cvals=None, avals=None,
                       dvals=None, scal=None, scal2=None, pro=PRO_NONE,
                       epi=EPI_NONE, aux=False):
    """Plain PyTorch version of :func:`winograd_call` (same arguments),
    the kernel's arithmetic in the kernel's order (module docstring), in
    any prologue with any epilogue whose operands it is given."""
    n, c, h, w = x.shape
    th, tw = -(-h // 2), -(-w // 2)
    z = _prologue(x, partner, scal, scal2, pro)
    # rows -1 .. 2*th and columns -1 .. 2*tw of the zero-padded z
    zp = F.pad(z, (1, 2 * tw - w + 1, 1, 2 * th - h + 1))
    d = [[zp[:, :, a:a + 2 * th:2, b:b + 2 * tw:2] for b in range(4)]
         for a in range(4)]
    rowc = [[_combo(BT[ki], [d[a][b] for a in range(4)]) for b in range(4)]
            for ki in range(4)]
    v = torch.stack([_combo(BT[kj], rowc[ki]) for ki in range(4)
                     for kj in range(4)])  # [16, N, C, th, tw] bf16
    m = torch.einsum("knchw,kcd->kndhw", v.float(), u.float())
    m = m.reshape(4, 4, *m.shape[1:])  # [ki, kj, N, Co, th, tw]
    r0 = [m[0, kj] + m[1, kj] + m[2, kj] for kj in range(4)]
    r1 = [m[1, kj] - m[2, kj] - m[3, kj] for kj in range(4)]
    o = torch.empty((n, u.shape[-1], 2 * th, 2 * tw), dtype=torch.float32,
                    device=x.device)
    for a, r in enumerate((r0, r1)):
        o[:, :, a::2, 0::2] = r[0] + r[1] + r[2]
        o[:, :, a::2, 1::2] = r[1] - r[2] - r[3]
    o = o[:, :, :h, :w]
    outs = []
    if epi == EPI_STATS:
        outs.append(torch.stack([o.sum((0, 2, 3)),
                                 (o * o).sum((0, 2, 3))]))
    elif epi == EPI_BN_ACT:
        bn = cvals * _per_channel(scal[0].to(torch.bfloat16)) \
            + _per_channel(scal[1].to(torch.bfloat16))
        g = torch.where(bn.float() > 0, o, 0.0)
        outs.append(torch.stack([g.sum((0, 2, 3)),
                                 (g * cvals.float()).sum((0, 2, 3))]))
        o = g * _per_channel(scal[0])
    elif epi == EPI_BN_ADD:
        # a was written by the forward's prologue, so a > 0 exactly where
        # the boundary's pre-activation is
        g = torch.where(avals.float() > 0, o + dvals.float(), 0.0)
        outs.append(torch.stack([g.sum((0, 2, 3)),
                                 (g * cvals.float()).sum((0, 2, 3))]))
        o = g * _per_channel(scal[0])
    outs.insert(0, o.to(torch.bfloat16))
    if aux:
        outs.append(z)
    if epi == EPI_BN_ADD:
        outs.append(g.to(torch.bfloat16))
    return tuple(outs)


# ------------------------------------------------------------ kernel --
def _check_cuda_args(x, u, partner, cvals, avals, dvals, scal, scal2, pro,
                     epi):
    """Device, dtype and shape checks of a kernel launch."""
    if x.device.type != "cuda":
        raise ValueError(f"winograd_call: no kernel for device {x.device}")
    n, c, h, w = x.shape
    co = u.shape[-1]
    if c % 8 or co % 8:
        raise ValueError(f"winograd_call: the kernel takes channel counts "
                         f"that are multiples of 8, got {c} -> {co}")
    want = [("u", u, torch.bfloat16, (16, c, co))]
    if pro in (PRO_BN_ADD, PRO_DYEFF):
        want.append(("partner", partner, torch.bfloat16, (n, c, h, w)))
    if pro == PRO_DYEFF:
        want.append(("scal2", scal2, torch.float32, (2, c)))
    if epi in (EPI_BN_ACT, EPI_BN_ADD):
        want += [("cvals", cvals, torch.bfloat16, (n, co, h, w)),
                 ("scal", scal, torch.float32, (2, co))]
    elif pro in (PRO_BN_ACT, PRO_BN_ADD):
        want.append(("scal", scal, torch.float32, (2, c)))
    if epi == EPI_BN_ADD:
        want += [("avals", avals, torch.bfloat16, (n, co, h, w)),
                 ("dvals", dvals, torch.bfloat16, (n, co, h, w))]
    for name, t, dt, shape in want:
        if t is None or t.device != x.device or t.dtype != dt \
                or tuple(t.shape) != shape:
            got = None if t is None else (t.dtype, tuple(t.shape),
                                          str(t.device))
            raise ValueError(f"winograd_call: {name} must be {dt} of shape "
                             f"{shape} on {x.device}, got {got}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def winograd_call(x: torch.Tensor, u: torch.Tensor,
                  partner: Optional[torch.Tensor] = None,
                  cvals: Optional[torch.Tensor] = None,
                  avals: Optional[torch.Tensor] = None,
                  dvals: Optional[torch.Tensor] = None,
                  scal: Optional[torch.Tensor] = None,
                  scal2: Optional[torch.Tensor] = None,
                  pro: int = PRO_NONE, epi: int = EPI_NONE,
                  aux: bool = False) -> Tuple[torch.Tensor, ...]:
    """The fused Winograd conv of NCHW ``x`` [N, C, H, W] with the bf16
    transformed weights ``u`` [16, C, Co] (:func:`transform_weights`).

    partner: the identity for PRO_BN_ADD, y for PRO_DYEFF ([N, C, H, W]);
    cvals: the forward input for EPI_BN_ACT and EPI_BN_ADD, avals the
    boundary activation and dvals its cotangent for EPI_BN_ADD (each
    [N, Co, H, W]); scal: float32 [2, C] (inv, shift) for PRO_BN_ACT and
    PRO_BN_ADD or [2, Co] for EPI_BN_ACT and EPI_BN_ADD; scal2: float32
    [2, C] (ds, dq) for PRO_DYEFF.  Activations are cast to bf16.  Returns
    JAX's order (out bf16 [N, Co, H, W], [stats float32 [2, Co]], [aux
    bf16 [N, C, H, W]], [out3 bf16 [N, Co, H, W]]), the bracketed ones
    when the epilogue has sums, when ``aux`` is set and for EPI_BN_ADD.

    CUDA tensors go to the kernel through the mode's launcher in
    :data:`KERNELS`, which counts the launch; CPU tensors go to
    :func:`winograd_reference`.  Modes outside :data:`MODES` raise."""
    mode = MODES.get((pro, epi))
    if mode is None:
        raise NotImplementedError(
            f"winograd_call: prologue {pro} with epilogue {epi} is not a "
            "mode of the kernel; the JAX package calls only the pairs of "
            "winograd.MODES")
    bf = torch.bfloat16
    x = x.to(bf)
    partner, cvals, avals, dvals = (None if t is None else t.to(bf)
                                    for t in (partner, cvals, avals, dvals))
    if x.device.type == "cpu":
        return winograd_reference(x, u, partner, cvals, avals, dvals, scal,
                                  scal2, pro, epi, aux)
    return KERNELS[mode](x, u, partner, cvals, avals, dvals, scal, scal2,
                         aux)


def _mode_kernel(pro: int, epi: int, mode: str):
    """The launcher of the kernel in one (prologue, epilogue) mode, with
    its own launch count ``.launches``."""

    def launch(x, u, partner, cvals, avals, dvals, scal, scal2, aux):
        _check_cuda_args(x, u, partner, cvals, avals, dvals, scal, scal2,
                         pro, epi)
        lib = kernel_library()
        n, c, h, w = x.shape
        co = u.shape[-1]
        dev = x.device
        x, u = x.contiguous(), u.contiguous()
        if u.data_ptr() % 16:  # the kernel reads u in 16-byte vectors
            u = u.clone()
        partner, cvals, avals, dvals, scal, scal2 = (
            None if t is None else t.contiguous()
            for t in (partner, cvals, avals, dvals, scal, scal2))
        out = torch.empty((n, co, h, w), dtype=torch.bfloat16, device=dev)
        aux_out = torch.empty_like(x) if aux else None
        out3 = torch.empty_like(out) if epi == EPI_BN_ADD else None
        reads_partner = pro in (PRO_BN_ADD, PRO_DYEFF)
        plan = winograd_plan(n, c, co, h, w, reads_partner,
                             {EPI_BN_ACT: 1, EPI_BN_ADD: 3}.get(epi, 0))
        # the 16-byte copies need x (and the partner) on 16 bytes too
        aligned = plan.aligned and x.data_ptr() % 16 == 0 and (
            not reads_partner or partner.data_ptr() % 16 == 0)
        # U in the blocks' shared-memory layout, one run per (co-block, k)
        ut = torch.empty(plan.co_blocks * 16 * _u_run_bytes(c),
                         dtype=torch.uint8, device=dev)
        stats = partial = None
        if epi != EPI_NONE:
            partial = torch.empty((plan.partial_rows, 2, co),
                                  dtype=torch.float32, device=dev)
            stats = torch.empty((2, co), dtype=torch.float32, device=dev)
        err = lib.yolo_winograd_f2x3(
            x.data_ptr(), _ptr(partner), u.data_ptr(), ut.data_ptr(),
            _ptr(cvals),
            _ptr(avals), _ptr(dvals), _ptr(scal), _ptr(scal2),
            out.data_ptr(), _ptr(aux_out), _ptr(out3), _ptr(partial),
            _ptr(stats), pro, epi, n, c, co, h, w, plan.rows,
            plan.seg_tiles, plan.segs, plan.cch, int(aligned), dev.index,
            _stream(x))
        check_launch(lib, err, f"winograd_call ({mode})")
        launch.launches += 1
        return tuple(t for t in (out, stats, aux_out, out3) if t is not None)

    launch.__name__ = launch.__qualname__ = f"winograd_{mode}"
    launch.launches = 0
    return launch


# the kernel's launcher per mode name, each with its launch count
KERNELS = {mode: _mode_kernel(pro, epi, mode)
           for (pro, epi), mode in MODES.items()}


# --------------------------------------------------------- the ops ----
def _wgrad(z: torch.Tensor, w: torch.Tensor, dye: torch.Tensor):
    """Weight gradient of the 3x3/s1/SAME conv on the library's
    convolution in bf16, from the kernel-materialized input ``z`` and
    output gradient ``dye`` (JAX ``_xla_wgrad_hwcn``)."""
    return torch.nn.grad.conv2d_weight(
        z.to(torch.bfloat16), tuple(w.shape), dye.to(torch.bfloat16),
        padding=1)


def _zeros_for(dy, ds, dq, y):
    """The cotangents (dy, ds, dq) of (y, sum, sumsq), an unused one as
    zeros."""
    dy = torch.zeros_like(y) if dy is None else dy
    zero = torch.zeros(y.shape[1], dtype=torch.float32, device=y.device)
    return (dy, zero if ds is None else ds.float(),
            zero if dq is None else dq.float())


class HConvStats(torch.autograd.Function):
    """y = conv3x3(x, w) with the per-channel (sum, sumsq) of y, the BN
    statistics of y from the conv's epilogue (JAX ``hconv_stats``)."""

    @staticmethod
    def forward(ctx, x, w):
        u = transform_weights(w).to(torch.bfloat16)
        y, stats = winograd_call(x, u, epi=EPI_STATS)
        ctx.save_for_backward(x, w, y)
        ctx.x_dtype = x.dtype
        return y, stats[0], stats[1]

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, y = ctx.saved_tensors
        dy, ds, dq = _zeros_for(dy, ds, dq, y)
        # the statistics' cotangents ride the gradient conv's read
        dx, dye = winograd_call(dy, _rot_u(w), partner=y,
                                scal2=_scal(ds, dq), pro=PRO_DYEFF,
                                epi=EPI_NONE, aux=True)
        return dx.to(ctx.x_dtype), _wgrad(x, w, dye).to(w.dtype)


class HConvBnActStats(torch.autograd.Function):
    """y = conv3x3(relu(x*inv + shift), w) with (sum, sumsq) of y: the
    previous BatchNorm's apply and relu ride the conv's input read, and
    z = relu(x*inv + shift) is written once for the weight gradient (JAX
    ``hconv_bn_act_stats``)."""

    @staticmethod
    def forward(ctx, x, w, inv, shift):
        u = transform_weights(w).to(torch.bfloat16)
        y, stats, z = winograd_call(x, u, scal=_scal(inv, shift),
                                    pro=PRO_BN_ACT, epi=EPI_STATS, aux=True)
        ctx.save_for_backward(x, w, inv, shift, y, z)
        ctx.x_dtype = x.dtype
        return y, stats[0], stats[1]

    @staticmethod
    def backward(ctx, dy, ds, dq):
        x, w, inv, shift, y, z = ctx.saved_tensors
        dy, ds, dq = _zeros_for(dy, ds, dq, y)
        # one kernel: the dy_eff prologue, the input-gradient conv, the
        # relu/BN mask epilogue with (sum g, sum g*x) -> (dshift, dinv)
        dx, sums, dye = winograd_call(
            dy, _rot_u(w), partner=y, cvals=x, scal=_scal(inv, shift),
            scal2=_scal(ds, dq), pro=PRO_DYEFF, epi=EPI_BN_ACT, aux=True)
        return (dx.to(ctx.x_dtype), _wgrad(z, w, dye).to(w.dtype),
                sums[1].to(inv.dtype), sums[0].to(shift.dtype))


class HConvBnAddActStats(torch.autograd.Function):
    """a = relu(ident + x*inv + shift), y = conv3x3(a, w), with (sum,
    sumsq) of y: the previous block's deferred residual boundary (its BN
    apply, the add and the relu) rides the conv's input read, and the
    boundary activation ``a``, this block's identity and the weight
    gradient's input, is written once (JAX ``hconv_bn_add_act_stats``)."""

    @staticmethod
    def forward(ctx, x, ident, w, inv, shift):
        u = transform_weights(w).to(torch.bfloat16)
        y, stats, a = winograd_call(x, u, partner=ident,
                                    scal=_scal(inv, shift), pro=PRO_BN_ADD,
                                    epi=EPI_STATS, aux=True)
        ctx.save_for_backward(x, w, inv, shift, y, a)
        ctx.dtypes = x.dtype, ident.dtype
        return y, a, stats[0], stats[1]

    @staticmethod
    def backward(ctx, dy, da_ext, ds, dq):
        x, w, inv, shift, y, a = ctx.saved_tensors
        dy, ds, dq = _zeros_for(dy, ds, dq, y)
        # one kernel: the dy_eff prologue, the input-gradient conv, the
        # boundary epilogue g = (conv + da_ext) * (a > 0) with g * inv
        # (x's gradient), g (the identity's) and (sum g, sum g*x) ->
        # (dshift, dinv); winograd_call casts da_ext to bf16, as JAX does
        dx, sums, dye, dident = winograd_call(
            dy, _rot_u(w), partner=y, cvals=x, avals=a, dvals=da_ext,
            scal=_scal(inv, shift),
            scal2=_scal(ds, dq), pro=PRO_DYEFF, epi=EPI_BN_ADD, aux=True)
        x_dtype, ident_dtype = ctx.dtypes
        return (dx.to(x_dtype), dident.to(ident_dtype),
                _wgrad(a, w, dye).to(w.dtype), sums[1].to(inv.dtype),
                sums[0].to(shift.dtype))


def hconv_stats(x: torch.Tensor, w: torch.Tensor):
    """(y bf16 [N, Co, H, W], sum [Co], sumsq [Co]) of conv3x3(x, w) for
    NCHW ``x`` and OIHW ``w``, differentiable in both."""
    return HConvStats.apply(x, w)


def hconv_bn_act_stats(x: torch.Tensor, w: torch.Tensor, inv: torch.Tensor,
                       shift: torch.Tensor):
    """(y, sum, sumsq) of conv3x3(relu(x*inv + shift), w), the BN apply in
    bf16; differentiable in x, w, inv and shift."""
    return HConvBnActStats.apply(x, w, inv, shift)


def hconv_bn_add_act_stats(x: torch.Tensor, ident: torch.Tensor,
                           w: torch.Tensor, inv: torch.Tensor,
                           shift: torch.Tensor):
    """(y, a, sum, sumsq) with a = relu(ident + x*inv + shift) in bf16 and
    y = conv3x3(a, w); differentiable in x, ident, w, inv and shift, and
    through both y and a."""
    return HConvBnAddActStats.apply(x, ident, w, inv, shift)


class _Conv3x3(torch.autograd.Function):
    """3x3/s1/SAME conv, bf16 in and out: forward and input gradient on
    the kernel, the weight gradient on the library conv (JAX
    ``conv3x3``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return winograd_call(x, transform_weights(w).to(torch.bfloat16))[0]

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = winograd_call(dy, _rot_u(w))[0]
        return dx.to(x.dtype), _wgrad(x, w, dy).to(w.dtype)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` (cast to bf16) conv OIHW ``w`` (cast to bf16), bf16."""
    return _Conv3x3.apply(x.to(torch.bfloat16), w.to(torch.bfloat16))


def conv3x3_stats(x: torch.Tensor, w: torch.Tensor):
    """:func:`hconv_stats` on bf16 casts of ``x`` and ``w``."""
    return hconv_stats(x.to(torch.bfloat16), w.to(torch.bfloat16))
