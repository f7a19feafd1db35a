"""The int8 kernels' vector path (``csrc/quant_int8.cu``) on the CPU.

``quant_dequant_int8`` and ``quantize_int8`` choose, on the host, between a
vector path (rows of whole 16-byte chunks: G lanes a row, V chunks a lane
held in registers, the row's absmax by xor shuffles inside the lane group,
whole-chunk stores, the codes packed little-endian into one word a chunk)
and the generic loop path. This file holds, before any card time:

- ``quant_int8_launch_plan``, the Python copy of the C launch rule, against
  a table of widths written out by hand, f32 and bf16 in, every out dtype,
  aligned and misaligned pointers;
- an emulation of the vector path's map from (block, warp, lane) to (row,
  chunk): every element covered once, a row's lanes one aligned group of G
  in one warp, xor partners inside the group, nothing stored past M or C;
- the emulated order of work (each lane's partial absmax, the shuffle
  tree, per-chunk arithmetic, the packed code words read back as int8)
  bit-equal to the plain versions (``quant_dequant_int8_plain``,
  ``quantize_int8_ref``) and to the JAX package's Pallas kernels in
  interpret mode, NaN, inf and zero rows included. Tolerance: none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant.int8 import quant_dequant_int8 as ref_fused
from repro.kernels.quant.int8 import quantize_int8 as ref_quantize
from repro_torch.kernels.quant.int8 import (CHUNK_BYTES, THREADS,
                                            quant_dequant_int8_plain,
                                            quant_int8_launch_plan)
from repro_torch.kernels.quant.ref import quantize_int8_ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
KERNELS = ("quant_dequant_int8", "quantize_int8")

# D -> (path, G, V) for f32 and for bf16 input, worked out by hand from the
# rule: C = D * size / 16 chunks, G = the power of two >= C (at most 32),
# V = ceil(C / G) <= 8; else the generic path
GENERIC = ("generic", 32, 0)
PLAN_TABLE = {
    1: (GENERIC, GENERIC),
    3: (GENERIC, GENERIC),
    4: (("vector", 1, 1), GENERIC),
    5: (GENERIC, GENERIC),
    8: (("vector", 2, 1), ("vector", 1, 1)),
    16: (("vector", 4, 1), ("vector", 2, 1)),
    32: (("vector", 8, 1), ("vector", 4, 1)),
    33: (GENERIC, GENERIC),
    36: (("vector", 16, 1), GENERIC),
    # the paper's cut widths at its SL splits (ResNet-18, GoogLeNet and
    # MobileNetV2): D 24 leaves 2 lanes of each group of 8 idle, D 832 is
    # the longest row of the link (7 chunks a lane)
    24: (("vector", 8, 1), ("vector", 4, 1)),
    64: (("vector", 16, 1), ("vector", 8, 1)),
    128: (("vector", 32, 1), ("vector", 16, 1)),
    160: (("vector", 32, 2), ("vector", 32, 1)),
    256: (("vector", 32, 2), ("vector", 32, 1)),
    480: (("vector", 32, 4), ("vector", 32, 2)),
    512: (("vector", 32, 4), ("vector", 32, 2)),
    576: (("vector", 32, 5), ("vector", 32, 3)),
    832: (("vector", 32, 7), ("vector", 32, 4)),
    1000: (("vector", 32, 8), ("vector", 32, 4)),
    1024: (("vector", 32, 8), ("vector", 32, 4)),
    1028: (GENERIC, GENERIC),
    2048: (GENERIC, ("vector", 32, 8)),
}


@pytest.mark.parametrize("in_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", sorted(PLAN_TABLE))
def test_launch_plan_rule(d, in_name):
    want = PLAN_TABLE[d][in_name == "bfloat16"]
    in_dtype = DTYPES[in_name][0]
    for kernel in KERNELS:
        for out_dtype in (torch.float32, torch.bfloat16):
            for aligned in (True, False):
                plan = quant_int8_launch_plan(7, d, in_dtype, out_dtype,
                                              aligned, kernel)
                got = (plan["path"], plan["lanes_per_row"],
                       plan["chunks_per_lane"])
                assert got == (want if aligned else GENERIC), \
                    (kernel, out_dtype, aligned, plan)
                assert plan["threads"] == THREADS
                assert plan["rows_per_block"] == 8 * 32 // got[1]
                assert plan["blocks"] == -(-7 // plan["rows_per_block"])


def test_launch_plan_at_the_link_shapes():
    """One wave of 392 blocks at the MobileNetV2 cut (132 SMs hold 8
    blocks of 256 threads each at <= 32 registers); 1,024 blocks of one
    row a warp at the SmolLM cut."""
    for kernel in KERNELS:
        cnn = quant_int8_launch_plan(12544, 32, torch.float32, kernel=kernel)
        lm = quant_int8_launch_plan(8192, 576, torch.float32, kernel=kernel)
        assert cnn == {"path": "vector", "lanes_per_row": 8,
                       "chunks_per_lane": 1, "rows_per_block": 32,
                       "blocks": 392, "threads": 256}
        assert lm == {"path": "vector", "lanes_per_row": 32,
                      "chunks_per_lane": 5, "rows_per_block": 8,
                      "blocks": 1024, "threads": 256}
    with pytest.raises(ValueError):
        quant_int8_launch_plan(0, 32, torch.float32)
    with pytest.raises(ValueError):
        quant_int8_launch_plan(8, 32, torch.float32, kernel="dequantize")


def lane_map(m, d, dtype):
    """Every thread of the vector path's grid: (block, warp, lane, row,
    sub, live) as the kernel's ``Lane<G>`` computes them, and the plan."""
    plan = quant_int8_launch_plan(m, d, dtype)
    assert plan["path"] == "vector"
    g = plan["lanes_per_row"]
    tid = np.arange(plan["blocks"] * THREADS)
    block, thread = tid // THREADS, tid % THREADS
    warp, lane = thread // 32, thread % 32
    row = (block * (THREADS // 32) + warp) * (32 // g) + lane // g
    return block, warp, lane, row, lane % g, row < m, plan


# the link shapes, and widths on every lane-group size and on V > 1
MAP_SHAPES = [(12544, 32, "float32"), (8192, 576, "float32"),
              (50176, 24, "float32"), (784, 832, "float32")] + [
    (m, d, dt) for m in (1, 7, 509)
    for d, dt in ((4, "float32"), (8, "float32"), (36, "float32"),
                  (32, "bfloat16"), (1000, "float32"), (2048, "bfloat16"))]


@pytest.mark.parametrize("m,d,dtype", MAP_SHAPES)
def test_vector_path_covers_every_element_once(m, d, dtype):
    block, warp, lane, row, sub, live, plan = lane_map(m, d,
                                                       DTYPES[dtype][0])
    g, v = plan["lanes_per_row"], plan["chunks_per_lane"]
    n_chunks = d * DTYPES[dtype][0].itemsize // CHUNK_BYTES
    stores = np.zeros((m, n_chunks), np.int64)   # chunk stores a place gets
    for k in range(v):
        j = sub + k * g
        ok = live & (j < n_chunks)               # the kernel's predicate
        np.add.at(stores, (row[ok], j[ok]), 1)
    assert (stores == 1).all()
    assert plan["blocks"] * plan["rows_per_block"] >= m
    assert not live[row >= m].any()
    # a row's lanes: one aligned group of G lanes in one warp
    for r in np.unique(row[live])[:: max(1, m // 64)]:
        sel = row == r
        assert len(set(block[sel])) == 1 and len(set(warp[sel])) == 1
        lanes = np.sort(lane[sel])
        assert lanes[0] % g == 0
        assert (lanes == lanes[0] + np.arange(g)).all()
    # the shuffle tree's partners lane ^ off stay in the group; every lane
    # of a warp, live or not, takes part (the kernel has no early return)
    off = g // 2
    while off:
        assert off < g and ((lane ^ off) // g == lane // g).all()
        off //= 2
    assert len(lane) == plan["blocks"] * THREADS


def _rows(m, d, dtype, seed):
    """x (and a residual) of very different row magnitudes in ``dtype``,
    with a NaN row (1), an inf row (2) and an all-zero row (3)."""
    rng = np.random.RandomState(seed + 11 * m + d)
    x = (rng.standard_normal((m, d))
         * rng.uniform(0.01, 10.0, size=(m, 1))).astype(np.float32)
    r = rng.standard_normal((m, d)).astype(np.float32)
    if m >= 4:
        x[1, d // 2] = np.nan
        x[2, d - 1] = -np.inf
        x[3, :] = 0.0
    tdt = DTYPES[dtype][0]
    return torch.from_numpy(x).to(tdt), torch.from_numpy(r).to(tdt)


def _f32_bits_of(t):
    """The chunk elements as the kernel's ``unpack`` forms them: f32 bits,
    a bf16 shifted into the high half of its f32."""
    if t.dtype == torch.float32:
        return t.numpy().view(np.uint32)
    return t.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) << 16


def _nan_max(a, b):
    nan = np.isnan(a) | np.isnan(b)
    return np.where(nan, np.float32(np.nan), np.fmax(a, b)).astype(np.float32)


def emulate(x, residual=None, out_dtype=None, quantize=False):
    """The vector path's order of work in numpy float32, lane by lane:
    fused -> the output tensor; quantize -> (codes int8 read back from the
    packed words, scales (M, 1) f32)."""
    m, d = x.shape
    n = CHUNK_BYTES // x.element_size()          # elements a chunk
    _, _, _, row, sub, live, plan = lane_map(m, d, x.dtype)
    g, v = plan["lanes_per_row"], plan["chunks_per_lane"]
    c = d // n
    xs = _f32_bits_of(x).view(np.float32).reshape(m, c, n)
    rs = (None if residual is None
          else _f32_bits_of(residual).view(np.float32).reshape(m, c, n))
    # lanes of live rows, in order: lane (row, sub); its chunks sub + k g
    lrow, lsub = row[live], sub[live]
    part = np.zeros(len(lrow), np.float32)
    for k in range(v):
        j = lsub + k * g
        ok = j < c
        chunk = np.zeros((len(lrow), n), np.float32)   # masked: zeros
        chunk[ok] = xs[lrow[ok], j[ok]]
        for e in range(n):
            part = _nan_max(part, np.abs(chunk[:, e]))
    # the xor tree: lane t of a group takes lane t ^ off's partial
    part = part.reshape(m, g)
    off = g // 2
    while off:
        part = _nan_max(part, part[:, np.arange(g) ^ off])
        off //= 2
    same = (part == part[:, :1]) | (np.isnan(part) & np.isnan(part[:, :1]))
    assert same.all()                            # every lane has the max
    s = part[:, :1] * np.float32(1.0 / 127.0)
    scale = np.where(np.isnan(s), s, np.maximum(s, np.float32(1e-8)))

    out = np.zeros((m, d), np.float32)
    words = np.zeros((m, c, n // 4), np.uint32)  # quantize: packed codes
    written = np.zeros((m, c), np.int64)
    with np.errstate(invalid="ignore"):          # NaN and inf rows
        for k in range(v):
            j = lsub + k * g
            ok = j < c
            rr, jj = lrow[ok], j[ok]
            f = xs[rr, jj]                       # (lanes, n)
            sc = scale[rr]
            q = np.rint(f / sc).astype(np.float32)
            if quantize:
                clip = np.minimum(np.maximum(q, -127), 127)
                code = np.where(np.isnan(q), 0, clip).astype(np.int8)
                byte = code.view(np.uint8).astype(np.uint32)
                for e in range(n):               # byte e % 4 of word e // 4
                    words[rr, jj, e // 4] |= (byte[:, e]
                                              << np.uint32(8 * (e % 4)))
            else:
                q = np.where(np.isnan(q), q,
                             np.minimum(np.maximum(q, -127), 127))
                if rs is None:
                    y = (q * sc).astype(np.float32)
                else:                            # one fma, rounded once
                    y = (q.astype(np.float64) * sc.astype(np.float64)
                         + rs[rr, jj].astype(np.float64)).astype(np.float32)
                out.reshape(m, c, n)[rr, jj] = y
            written[rr, jj] += 1
    assert (written == 1).all()
    if quantize:
        codes = words.reshape(m, -1).view(np.int8).reshape(m, d)
        return torch.from_numpy(codes.copy()), torch.from_numpy(scale)
    return torch.from_numpy(out).to(out_dtype or x.dtype)


def _same(a, b):
    a, b = a.float(), b.float()
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


def _jax(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _torch(a):
    return torch.from_numpy(np.array(a.astype(jnp.float32)))


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 24, 32, 576, 832])
@pytest.mark.parametrize("m", [7, 509])
def test_emulated_fused_kernel_is_bit_equal(m, d, dtype, residual):
    x, r = _rows(m, d, dtype, seed=0)
    r = r if residual else None
    for out_name, (out_dtype, out_jdt) in DTYPES.items():
        got = emulate(x, r, out_dtype)
        assert got.dtype == out_dtype
        assert _same(got, quant_dequant_int8_plain(x, residual=r,
                                                   out_dtype=out_dtype))
        want = ref_fused(_jax(x), residual=None if r is None else _jax(r),
                         out_dtype=out_jdt, interpret=True)
        assert _same(got, _torch(want)), out_name
    if not residual:
        assert torch.isnan(got[1].float()).all()      # NaN fills its row
        assert (got[3] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 24, 32, 576, 832])
@pytest.mark.parametrize("m", [7, 509])
def test_emulated_packed_codes_are_bit_equal(m, d, dtype):
    x, _ = _rows(m, d, dtype, seed=1)
    codes, scales = emulate(x, quantize=True)
    want_c, want_s = quantize_int8_ref(x)
    assert codes.dtype == torch.int8
    assert torch.equal(codes, want_c) and _same(scales, want_s)
    ref_c, ref_s = ref_quantize(_jax(x), interpret=True)
    assert torch.equal(codes, torch.from_numpy(np.array(ref_c)))
    assert _same(scales, torch.from_numpy(np.array(ref_s)))
    assert (codes[1] == 0).all() and torch.isnan(scales[1, 0])


def test_packed_code_word_is_little_endian():
    """Byte k of a chunk's word is element k: codes 127, -2, 3, -4 of an
    f32 chunk pack to 0xFC03FE7F."""
    x = torch.tensor([[127.0, -2.0, 3.0, -4.0]])
    codes, _ = emulate(x, quantize=True)
    assert codes.tolist() == [[127, -2, 3, -4]]
    word = codes.numpy().view(np.uint32)[0, 0]
    assert word == 0xFC03FE7F
