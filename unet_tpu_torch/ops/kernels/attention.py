"""Attention, forward and backward: the CUDA kernels' wrappers, their plain
versions, and the autograd Function that joins the two.

Counterpart of unet_tpu/ops/pallas/attention.py.  `qkv_attention_fwd`
replaces the Pallas forward kernel there (`_fwd_kernel`, :41, launched by
`_fwd_call`, reached through `qkv_attention_fused`) and `qkv_attention_bwd`
the backward kernel (`_bwd_kernel`, :61, launched by `_bwd_call`, reached
through `_att_bwd`), both with csrc/attention.cu: non-causal multi-head
attention straight from the packed (B, T, 3C) QKV tensor, [q | k | v] with
each C split contiguously into (NH, HS).  `QKVAttention` is the counterpart
of the `custom_vjp` `qkv_attention_fused`: its only residual is qkv.

What bounds it on an H100: the forward moves `4 * B*T*C * itemsize` bytes
and does `4 * B*NH*T*T*HS` operations, the backward `7 * B*T*C * itemsize`
and `10 * B*NH*T*T*HS`; in bfloat16 that is T/2 and 5T/7 operations a
byte, below the card's 295 at the U-Net's T = 64 and 256, so device memory
bounds both there.  In float32 (4-byte values) it is T/4 and 5T/14
against 49 for 3xTF32 (165 TFLOP/s), the card's fastest product that keeps
the float32 bar: device memory bounds T = 64, the operations T = 256.
So at DDPM CIFAR-10's one head of 256 at T = 256, B = 128 (the chunked
kernels), the forward's bound is 0.0200 ms in bfloat16 (bytes) and 0.0521
in float32 (operations), the backward's 0.0350 and 0.1301: a kernel that
computed each score more than once would spend work these bounds have no
room for, which is why the chunked kernels share a tile's scores.
Every product is on the tensor cores (`route`): bf16 tiles in bfloat16
(`mma.sync`; `wgmma` in the chunked kernels); in float32 three TF32 products per product (3xTF32: each operand
split into a TF32 pair hi + lo, a b taken as a_hi b_lo + a_lo b_hi + a_hi
b_hi, which leaves out about 2^-22 of each product and so keeps the 2e-5
float32 bar, where one TF32 product misses it by about 20x; see
tests/test_torch_tf32.py).  A warp owns 16 query (or key) rows, four warps
(64 rows) a block; the other side is staged in shared memory by
`cp.async`, with an online softmax in registers; the scores never reach
device memory and any T is taken (the ragged tile is masked).  The kernels
take every head size, as the JAX package's do: a head of up to 64 columns
whose row is a multiple of 16 bytes in tiles of the first width of
`HEAD_SIZES` at or above it (the columns past the head size zero); any
other head of up to `CHUNK * MAX_CHUNKS` in chunks of `CHUNK` columns
(csrc/attention_chunked.cu): one block per tile of `CHUNKED_ROWS` rows,
one group of warps a chunk (a warpgroup in bfloat16, on `wgmma`), each
group the score products over its own chunk, the block adding the
partial scores in shared memory in group order, then each group its own
chunk of the output; a wider head in thread-block clusters of up to
`MAX_CLUSTER` such blocks (csrc/attention_wide.cu), each block the score
products over its own run of chunks, its groups' partials summed in
shared memory, one partial a block added up through distributed shared
memory in rank order (the cluster barrier split around the next stage's
score products), then each group its chunk of the output
(`kernel_layout` says which a head takes, and how many chunks a block
holds).  The plain version takes any head size.

The backward recomputes the scores from qkv in two kernels that need no
order between blocks: one for dq and the rows' softmax statistics (two
sweeps over the keys), then one for dk and dv (a sweep over the queries).
"""

from __future__ import annotations

import ctypes
import math

import torch

from unet_tpu_torch.ops.kernels import _build

# The tile widths csrc/attention.cu's kernels are compiled for
# (`with_head_size` there); other heads go in chunks of CHUNK columns (`CH`
# in csrc/attention.cuh), at most MAX_CHUNKS of them in the chunked kernels,
# wider heads in clusters of at most MAX_CLUSTER blocks.  The chunked and
# cluster kernels' blocks take CHUNKED_ROWS rows (`Geo` in
# csrc/attention.cuh); a cluster's block holds at most BLOCK_CHUNKS chunks
# (`MOST_CHUNKS` in csrc/attention_wide.cu), fewer where the launch would
# have fewer than MIN_BLOCKS blocks (`MIN_BLOCKS`: half an H100's SMs;
# utils/attn_sweep.py times the alternatives).
HEAD_SIZES = (16, 32, 64)
CHUNK = 64
MAX_CHUNKS = 4
MAX_CLUSTER = 8
CHUNKED_ROWS = {torch.bfloat16: 64, torch.float32: 32}
BLOCK_CHUNKS = {torch.bfloat16: 4, torch.float32: 2}
MIN_BLOCKS = 64


def row_tiles(B, T, num_heads, dtype):
    """The tiles of `CHUNKED_ROWS` own rows of a launch: B * NH * ceil(T /
    rows), what the cluster kernels' grid-size rule counts."""
    return B * num_heads * -(-T // CHUNKED_ROWS[dtype])


def kernel_layout(head_size, dtype, row_tiles=None, most=None):
    """How the kernels take a head of `head_size` columns of `dtype`:
    ("tile", W), a block's rows in tiles W wide (the first of `HEAD_SIZES`
    at or above it; a row of a multiple of 16 bytes); ("chunked", nd), the
    head in nd chunks of `CHUNK` columns (at most `MAX_CHUNKS`), one block
    of nd groups of warps a tile of rows, group g the score products over
    chunk g and chunk g of the output; or, wider, ("cluster", n, per,
    chunks): clusters of n blocks, each block a run of at most `chunks`
    chunks (a group of warps each), in `per` groups of clusters
    (`wide_layout` in csrc/attention_wide.cu).  A block takes the most of
    `BLOCK_CHUNKS` (or `most`), then half that, ..., that keeps the cluster within
    `MAX_CLUSTER` blocks and a launch of `row_tiles` tiles of rows (None: a
    launch large enough for any) at `MIN_BLOCKS` blocks or more; else one
    chunk a block, in per = ceil(nd / MAX_CLUSTER) groups of clusters each
    recomputing the scores."""
    nd = -(-head_size // CHUNK)
    if nd > MAX_CHUNKS:
        c = most or BLOCK_CHUNKS[dtype]
        while c > 1:
            n = -(-nd // c)
            if n <= MAX_CLUSTER and (row_tiles is None
                                     or row_tiles * n >= MIN_BLOCKS):
                return ("cluster", n, 1, -(-nd // n))
            c //= 2
        n = min(nd, MAX_CLUSTER)
        return ("cluster", n, -(-nd // n), 1)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if head_size * itemsize % 16 == 0:
        for width in HEAD_SIZES:
            if head_size <= width:
                return ("tile", width)
    return ("chunked", nd)


def work_ratio(head_size, dtype, backward, row_tiles=None):
    """The tensor-core work the kernels do for a head of `head_size`
    columns over the same products exactly `head_size` deep and wide (1.0:
    nothing wasted), at the layout `kernel_layout` gives for `row_tiles`.
    A tile W wide does every product over W columns.  Chunked, the block's
    groups share the scores: each score product (forward: s; backward: s
    and dp twice in the dq kernel, once in the dk/dv kernel) over the whole
    head once, split by chunk between the groups, and the output products
    (out; dq, dk and dv) over each group's own chunk; in clusters, each of
    the `per` groups of clusters does the score products over the whole
    head once, split between its blocks, and the output products over its
    own chunks (1.0 wherever one group of clusters holds the head).  Both
    k-step by k-step, the output products' width too: 16 columns in
    bfloat16 (`wgmma`'s N), 8 in float32."""
    kind, n, *rest = kernel_layout(head_size, dtype, row_tiles)
    if kind == "tile":
        return n / head_size
    nd = -(-head_size // CHUNK)
    step = 16 if dtype == torch.bfloat16 else 8
    depth = sum(-(-min(CHUNK, head_size - d * CHUNK) // step) * step
                for d in range(nd))
    repeats = rest[0] if kind == "cluster" else 1
    scores, outputs = (6, 3) if backward else (1, 1)
    return ((scores * repeats + outputs) * depth
            / ((scores + outputs) * head_size))


def head_size_fault(widths, head_size):
    """Why attention cannot run at these channel widths with `head_size`
    channels a head (the model's `num_head_channels`), or None if it can.
    The JAX package's rule (unet_tpu/models/blocks.py: `num_heads = C //
    head_size`, each head C // num_heads wide): a width is refused where it
    gives no head or heads that do not split it, exactly where the JAX
    package's attention raises; the kernels take every other head.  The
    CLIs ask this before they build a model, `_check_cuda` before a
    launch."""
    if head_size < 1:
        return f"head size {head_size} is not positive"
    for width in sorted(set(widths)):
        heads = width // head_size
        if heads == 0:
            return (f"attention width {width} is narrower than a head of "
                    f"{head_size}: no head")
        if width % heads:
            return (f"{heads} heads (width {width} // head size "
                    f"{head_size}) do not split the attention width {width}")
    return None


def route(dtype):
    """The tensor-core route the launchers take for a call of this type:
    "bf16" (bf16 operands: `mma.sync`, `wgmma` in the chunked and cluster
    kernels) or
    "3xtf32" (float32 as three TF32 `mma.sync` products;
    csrc/attention.cu's `*_tf32_kernel`s)."""
    return "bf16" if dtype == torch.bfloat16 else "3xtf32"


def qkv_attention_plain(qkv, num_heads):
    """Plain PyTorch version with the kernel's rounding points: q * scale
    rounded to the input type before the score product, scores and softmax
    in float32 (float64 for float64 input), the weights rounded to the
    input type before the value product, which accumulates in float32."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    q, k, v = (a.reshape(B, T, num_heads, HS) for a in qkv.split(C, dim=-1))
    qs = q * (1.0 / math.sqrt(HS))
    scores = torch.einsum("bthd,bshd->bhts", qs.to(acc), k.to(acc))
    weights = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhts,bshd->bthd", weights.to(acc), v.to(acc))
    return out.to(qkv.dtype).reshape(B, T, C)


def _check(qkv, num_heads):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (B, T, 3C), got {tuple(qkv.shape)}")
    C = qkv.shape[-1] // 3
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"C={C} does not split into {num_heads} heads")


def _check_cuda(qkv, num_heads):
    """What the kernels take beyond `_check`."""
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"the kernel takes float32 or bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    B, T, C3 = qkv.shape
    C = C3 // 3
    fault = head_size_fault([C], C // num_heads)
    if fault is not None:
        raise ValueError(f"{fault} (C={C}, {num_heads} heads)")
    if B == 0 or T == 0:
        raise ValueError(f"empty input {tuple(qkv.shape)}")
    # grid (x, y, B): x the tiles of rows (a cluster's n blocks side by
    # side), y the heads (times the groups of clusters)
    layout = kernel_layout(C // num_heads, qkv.dtype,
                           row_tiles(B, T, num_heads, qkv.dtype))
    rows = 64 if layout[0] == "tile" else CHUNKED_ROWS[qkv.dtype]
    blocks_x, blocks_y = -(-T // rows), num_heads
    if layout[0] == "cluster":
        blocks_x, blocks_y = blocks_x * layout[1], num_heads * layout[2]
    if B > 65535 or blocks_y > 65535 or blocks_x > 2**31 - 1:
        raise ValueError(f"the kernel does not take B={B}, T={T}, "
                         f"NH={num_heads} (grid {blocks_x} x {blocks_y})")


def qkv_attention_fwd(qkv, num_heads):
    """Multi-head attention over qkv (B, T, 3C) -> (B, T, C).

    A CUDA tensor goes to the hand-written kernel (float32 or bfloat16,
    contiguous, any head size) or raises; only a CPU tensor takes the plain
    version."""
    _check(qkv, num_heads)
    if qkv.device.type == "cpu":
        return qkv_attention_plain(qkv, num_heads)
    _check_cuda(qkv, num_heads)
    B, T, C3 = qkv.shape
    C = C3 // 3
    out = torch.empty((B, T, C), dtype=qkv.dtype, device=qkv.device)
    if qkv.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("qkv must be 16-byte aligned")
    fn = _launcher("unet_qkv_attention_fwd")
    with torch.cuda.device(qkv.device):
        code = fn(qkv.data_ptr(), out.data_ptr(), B, T, C, num_heads,
                  1.0 / math.sqrt(C // num_heads),
                  int(qkv.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "qkv_attention_fwd")
    qkv_attention_fwd.launches += 1
    return out


# Launches of the kernel since the count was last set to 0.
qkv_attention_fwd.launches = 0


def qkv_attention_bwd_plain(qkv, dout, num_heads):
    """Plain PyTorch attention backward with the rounding points of the
    kernel and of the TPU kernel's `_bwd_kernel`: scores and the softmax
    recomputed from qkv in float32 (float64 for float64 input), dout taken in
    v's type, p kept in float32 inside ds = p (dp - rowsum(dp p)), ds and p
    rounded to the input type before the products that give dq = (ds k) *
    scale, dk = ds^T qs and dv = p^T dout, each accumulated in float32.
    Returns d(qkv) (B, T, 3C) in qkv's type."""
    B, T, C3 = qkv.shape
    C = C3 // 3
    HS = C // num_heads
    dt = qkv.dtype
    acc = torch.promote_types(dt, torch.float32)
    scale = 1.0 / math.sqrt(HS)
    q, k, v = (a.reshape(B, T, num_heads, HS).to(acc)
               for a in qkv.split(C, dim=-1))
    qs = (q * scale).to(dt).to(acc)
    dob = dout.reshape(B, T, num_heads, HS).to(dt).to(acc)
    p = torch.softmax(torch.einsum("bthd,bshd->bhts", qs, k), dim=-1)
    dp = torch.einsum("bthd,bshd->bhts", dob, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dsb = ds.to(dt).to(acc)
    dq = torch.einsum("bhts,bshd->bthd", dsb, k) * scale
    dk = torch.einsum("bhts,bthd->bshd", dsb, qs)
    dv = torch.einsum("bhts,bthd->bshd", p.to(dt).to(acc), dob)
    return torch.cat([a.reshape(B, T, C) for a in (dq, dk, dv)],
                     dim=-1).to(dt)


def qkv_attention_bwd(qkv, dout, num_heads):
    """Backward of `qkv_attention_fwd` from qkv and dout (B, T, C) alone.
    Returns d(qkv) (B, T, 3C) in qkv's type.

    A CUDA tensor goes to the hand-written kernels (the forward's types and
    head size; dout of any strides is made contiguous first) or raises; only
    a CPU tensor takes the plain version."""
    _check(qkv, num_heads)
    B, T, C3 = qkv.shape
    C = C3 // 3
    if dout.shape != (B, T, C):
        raise ValueError(f"dout must be ({B}, {T}, {C}), got "
                         f"{tuple(dout.shape)}")
    if qkv.device.type == "cpu":
        return qkv_attention_bwd_plain(qkv, dout, num_heads)
    _check_cuda(qkv, num_heads)
    if dout.dtype != qkv.dtype or dout.device != qkv.device:
        raise TypeError(f"dout must be {qkv.dtype} on {qkv.device}")
    dout = dout.contiguous()
    dqkv = torch.empty_like(qkv)
    # The rows' softmax maximum, 1 / sum and D, from the first kernel to the
    # second (see `gn_act_fwd` on the lifetime of scratch).
    stats = torch.empty((3, B, num_heads, T), dtype=torch.float32,
                        device=qkv.device)
    if qkv.data_ptr() % 16 or dout.data_ptr() % 16 or dqkv.data_ptr() % 16:
        raise ValueError("qkv and dout must be 16-byte aligned")
    fn = _launcher("unet_qkv_attention_bwd")
    with torch.cuda.device(qkv.device):
        code = fn(qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                  stats.data_ptr(), B, T, C, num_heads,
                  1.0 / math.sqrt(C // num_heads),
                  int(qkv.dtype == torch.bfloat16),
                  torch.cuda.current_stream().cuda_stream)
    _build.check_launch(code, "qkv_attention_bwd")
    qkv_attention_bwd.launches += 1
    return dqkv


# Launches of the kernel since the count was last set to 0.
qkv_attention_bwd.launches = 0


class QKVAttention(torch.autograd.Function):
    """out = attention(qkv) with `qkv_attention_fwd` forward and
    `qkv_attention_bwd` backward; the only residual is qkv, as in the JAX
    package's `_att_fwd`/`_att_bwd`.  `fwd` and `bwd` are the two functions
    it calls (chip_smoke.py sets them to the plain versions for its
    comparisons)."""

    fwd = staticmethod(qkv_attention_fwd)
    bwd = staticmethod(qkv_attention_bwd)

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        return QKVAttention.fwd(qkv, num_heads)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return QKVAttention.bwd(qkv, dout, ctx.num_heads), None


_ARGTYPES = {
    "unet_qkv_attention_fwd": "pp" "iiii" "f" "i" "p",
    "unet_qkv_attention_bwd": "pppp" "iiii" "f" "i" "p",
    # the cluster kernels at a given most chunks a block (utils/attn_sweep.py)
    "unet_qkv_attention_fwd_cluster": "pp" "iiii" "f" "ii" "p",
    "unet_qkv_attention_bwd_cluster": "pppp" "iiii" "f" "ii" "p",
}


def _launcher(name):
    fn = getattr(_build.load(), name)
    if fn.argtypes is None:
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int,
                 "f": ctypes.c_float}
        fn.argtypes = [kinds[k] for k in _ARGTYPES[name]]
        fn.restype = ctypes.c_int
    return fn
