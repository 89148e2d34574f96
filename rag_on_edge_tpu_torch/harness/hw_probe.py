"""Platform probes: the card's ceilings and its fixed costs
(counterpart: ``rag_on_edge_tpu/harness/hw_probe.py``), with kernels
K11-K14.

The probes measure what the port's kernels are judged against:

1. ``probe_xla`` — plain torch ops (the JAX version's XLA ops): GEMM
   TOPS through ``torch._int_mm`` and ``torch.mm``, and the GB/s of a
   1 GiB reduce and a 1 GiB read-plus-write copy;
2. ``probe_pallas_step`` — kernel K11, a trivial kernel over g steps: the
   slope over g is the fixed cost of a step; beside it, the cost of one
   launch, eager and captured in a CUDA graph;
3. ``probe_pallas_stream`` — kernel K12, a 512 MB tile walk, optionally
   through a product with a resident x: streaming GB/s;
4. ``probe_pallas_dma`` — kernel K13, a 2 GiB walk through a ring of
   ``depth`` bulk async copies per CTA: marginal GB/s (a full walk against
   a quarter walk of the same array);
5. ``probe_pallas_gemm`` — kernel K14, g steps of a resident product: the
   slope over g is the in-kernel matrix rate, on the tensor cores
   (``unit="mma"``: ``wgmma``, the instruction the port's int8 and bf16
   kernels run on) and, for int8, on ``__dp4a`` (which only K9's
   ``accum_extract_kernel`` still runs on).

Each kernel function keeps the JAX name and arguments.  CPU tensors take
its plain version (``*_reference``); CUDA tensors launch
``csrc/hw_probe.cu`` or raise; there is no fallback.  ``_stream_steps``
and ``_gemm_rate_steps`` return K12's and K14's per-step maxima, which the
checks hold whole against the plain versions.  Launches on the device
count in ``LAUNCHES``, keyed K11-K14: each kernel a call runs, and each
replay of a CUDA graph the probes time.  The probes run on ``device="cuda"`` unless
the caller passes ``device="cpu"`` (the tests, at toy sizes through the
size keywords); their defaults are the JAX sizes.  On the card a time is
device time from :func:`timing.graph_ms` (the calls captured in one CUDA
graph, so that the wrapper's host time between calls does not hide the
small probes' device time), not the JAX version's chained throughput:
``timing``'s docstring says why the JAX probes' per-call input
perturbation is not needed; on the CPU it is the host clock.

Usage (on the card)::

    python -m rag_on_edge_tpu_torch.harness.hw_probe --probes xla pallas_step
    python -m rag_on_edge_tpu_torch.harness.hw_probe            # everything
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from rag_on_edge_tpu_torch.harness import timing
from rag_on_edge_tpu_torch.ops import _build

__all__ = ["LAUNCHES", "PROBES", "SEMANTICS", "UNITS", "probe_xla", "probe_pallas_step",
           "probe_pallas_stream", "probe_pallas_dma", "probe_pallas_gemm", "main"]

#: Kernel launches on the device of K11-K14 in this process (K13 and K14
#: run two kernels a call, the walk and a final max); the plain versions do
#: not count.  A call under CUDA graph capture records its kernels in
#: ``_CAPTURED`` instead, and :func:`_graph_ms` adds them once for each
#: replay.  A run that must show it went through a kernel sets its entry to
#: 0 before and reads it after.
LAUNCHES = {"K11": 0, "K12": 0, "K13": 0, "K14": 0}
_CAPTURED = dict.fromkeys(LAUNCHES, 0)

SEMANTICS = (None, "arbitrary", "parallel")
UNITS = ("mma", "dp4a")

_DTYPES = (torch.int8, torch.bfloat16)
_NAMES = {torch.int8: "int8", torch.bfloat16: "bfloat16", torch.float32: "float32"}
# The plain versions' products: int8 in float64, exact at any d (as the JAX
# probes' int32 sums), bf16 in float32.
_ACC = {torch.int8: torch.float64, torch.bfloat16: torch.float32}
# K13's ring on the card: at most 8 stages of 16 KB per CTA, whatever the
# JAX depth (which only picks the blocks walked).
_MAX_RING = 8
# Elements of one chunk of a plain version's score tensor.
_CHUNK = 1 << 26

# graph_ms replays its graph this many times, plus one warm-up replay.
_REPLAYS = 3

_FNS: dict[str, object] = {}


def _kernel(name: str, nptr: int, nint: int, longlong: bool = False):
    """Build/load the library once and declare one C entry's types:
    ``nptr`` pointers, ``nint`` ints (the first a ``long long`` where
    ``longlong``), then the stream."""
    if name not in _FNS:
        fn = getattr(_build.load_library("hw_probe"), name)
        ints = [ctypes.c_int] * nint
        if longlong:
            ints[0] = ctypes.c_longlong
        fn.argtypes = [ctypes.c_void_p] * nptr + ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _launch(key: str, name: str, dev: torch.device, fn, *args, kernels: int = 1) -> None:
    """Call C entry ``fn`` on ``dev``'s current stream (tensors pass as
    their data pointers), raise on a refused launch, count its ``kernels``
    (as captured, under CUDA graph capture)."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    (_CAPTURED if capturing else LAUNCHES)[key] += kernels


def _graph_ms(fn, dev, calls: int) -> float:
    """:func:`timing.graph_ms`, with the kernels its graph launches counted:
    those ``calls`` recorded under capture, once for each replay."""
    before = dict(_CAPTURED)
    ms = timing.graph_ms(fn, dev, calls=calls, replays=_REPLAYS)
    for key in LAUNCHES:
        LAUNCHES[key] += (_CAPTURED[key] - before[key]) * (_REPLAYS + 1)
    return ms


def _check_semantics(semantics) -> None:
    if semantics not in SEMANTICS:
        raise ValueError(f"unknown semantics {semantics!r}; one of {SEMANTICS}")


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _empty(n, device):
    return torch.empty(n, dtype=torch.float32, device=device)


def _nans(n, device):
    return torch.full((n,), float("nan"), dtype=torch.float32, device=device)


# --------------------------------------------------------- K11: step probe


def _step_input(x, g, moving):
    if x.shape != (8, 128) or x.dtype != torch.float32:
        raise ValueError(f"expected x [8, 128] float32, got {tuple(x.shape)} {x.dtype}")
    if g < 1:
        raise ValueError(f"g must be >= 1, got {g}")
    # The moving input is materialised, as the JAX version's broadcast is.
    return x.expand(g, 8, 128).reshape(g * 8, 128) if moving else x


def _step_probe_reference(x, g, moving, semantics):
    """Plain K11 → [1] f32: twice element 0 of the last step's tile (tile 0
    of x when pinned, tile g-1 of x broadcast to [g, 8, 128] when moving)."""
    _check_semantics(semantics)
    inp = _step_input(x, g, moving)
    tile = inp[(g - 1) * 8:g * 8] if moving else inp
    return (tile * 2.0).reshape(-1)[:1]


def _step_probe(x, g, moving, semantics):
    """K11 with the JAX signature → [1] f32; see
    :func:`_step_probe_reference`.  On the card, None and "parallel" run a
    CTA per step (only step g-1 writes), "arbitrary" one CTA looping over
    the steps in order; every step loads its 4 KB tile."""
    _check_semantics(semantics)
    inp = _step_input(x, g, moving)
    dev = x.device
    if dev.type == "cpu":
        return _step_probe_reference(x, g, moving, semantics)
    _build.check_inputs("K11", dev, [inp])
    inp = _build.aligned(inp, 16)
    out = torch.empty((8, 128), dtype=torch.float32, device=dev)
    fn = _kernel("hw_step_probe", 2, 3)
    _launch("K11", "hw_step_probe", dev, fn, inp, out, g, int(moving),
            int(semantics == "arbitrary"))
    return out.reshape(-1)[:1]


# ------------------------------------------------------- K12: stream probe


def _stream_check(x, data, blk, fat, gemm):
    """The JAX function's shapes → the number of steps g."""
    if data.dim() != 3 or data.shape[2] != blk:
        raise ValueError(f"expected data [nblocks, d, {blk}], got {tuple(data.shape)}")
    if data.dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {data.dtype} (int8 or bfloat16)")
    nblocks, d, _ = data.shape
    if fat < 1 or (fat > 1 and nblocks % fat):
        raise ValueError(f"fat={fat} must divide nblocks={nblocks}")
    if nblocks < fat:
        raise ValueError("the walk has no step")
    if gemm and (x.dim() != 2 or x.shape[1] != d or x.dtype != data.dtype):
        raise ValueError(f"expected x [m, {d}] {data.dtype}, got {tuple(x.shape)} {x.dtype}")
    return nblocks // fat


def _stream_steps_reference(x, data, fat, gemm):
    """Every step's max → [g] f32 (max(tile), or max(x @ tile), exact for
    int8 at any d, f32 for bf16, over the step's fat blocks)."""
    nblocks, d, blk = data.shape
    g = nblocks // fat
    steps = data.reshape(g, fat * d * blk) if not gemm else data.reshape(g, fat, d, blk)
    if not gemm:
        return steps.amax(dim=1).to(torch.float32)
    acc = _ACC[data.dtype]
    xa = x.to(acc)
    out = []
    chunk = max(1, _CHUNK // (fat * x.shape[0] * blk))
    for s in range(0, g, chunk):
        out.append(torch.matmul(xa, steps[s:s + chunk].to(acc)).amax(dim=(1, 2, 3)))
    return torch.cat(out).to(torch.float32)


def _stream_probe_reference(x, data, blk, fat, gemm, semantics):
    """Plain K12 → [1] f32: the last step's max.  Its output window is
    pinned, so on the TPU each step overwrites it and the last step's max
    lands (with "parallel", interpreted, the step that lands last); every
    step's max is computed all the same, as the kernel does."""
    _check_semantics(semantics)
    _stream_check(x, data, blk, fat, gemm)
    return _stream_steps_reference(x, data, fat, gemm)[-1:]


def _stream_launch(x, data, blk, fat, gemm, semantics, fill):
    """K12's kernel on the card → [g] f32, each step's max, written into a
    buffer made by ``fill`` (``torch.empty``, or a NaN fill where a check
    must see a step the kernel skipped)."""
    g = _stream_check(x, data, blk, fat, gemm)
    dev = data.device
    _build.check_inputs("K12", dev, [x, data])
    _, d, _ = data.shape
    es = data.element_size()
    m = ldx = 0
    if gemm:
        # cp.async moves 4-byte pieces: x's rows and the tiles' rows padded
        # to a multiple of 4 bytes with zeros (zero terms move no product;
        # the kernel masks the columns past blk).
        m = x.shape[0]
        x = _build.aligned(_build.pad_rows(x, 4 // es), 4)
        data = _build.aligned(_build.pad_rows(data, 4 // es), 4)
        ldx = x.shape[1] * es
    steps = fill(g, device=dev)
    fn = _kernel("hw_stream_probe", 3, 10)
    _launch("K12", "hw_stream_probe", dev, fn, x, data, steps, m, ldx, d, blk, data.shape[2],
            fat, g, int(gemm), int(semantics == "arbitrary"), int(data.dtype == torch.bfloat16))
    return steps


def _stream_probe(x, data, blk, fat, gemm, semantics):
    """K12 with the JAX signature → [1] f32; see
    :func:`_stream_probe_reference`.  ``data`` [nblocks, d, blk] int8 or
    bf16, walked ``fat`` blocks a step; with ``gemm`` through a product
    with ``x`` [m, d] (any m and d, x's row tiles of 128 in turn; on the
    tensor cores through ``wgmma``, the walk's 16 KB units through a
    ``cp.async`` ring, x resident or riding in it).  On the card, None
    and "parallel" run a CTA per step, "arbitrary" one CTA per SM walking a
    contiguous run of steps; each step's max is written, and the last one
    returned."""
    _check_semantics(semantics)
    if data.device.type == "cpu":
        if x.device != data.device:
            raise ValueError("all K12 inputs must be on one device")
        return _stream_probe_reference(x, data, blk, fat, gemm, semantics)
    return _stream_launch(x, data, blk, fat, gemm, semantics, _empty)[-1:]


def _stream_steps(x, data, blk, fat, gemm, semantics):
    """Every step's max → [g] f32: on the card the kernel's whole ``steps``
    buffer, NaN where no CTA wrote; on the CPU the plain version."""
    _check_semantics(semantics)
    if data.device.type == "cpu":
        _stream_check(x, data, blk, fat, gemm)
        return _stream_steps_reference(x, data, fat, gemm)
    return _stream_launch(x, data, blk, fat, gemm, semantics, _nans)


# ---------------------------------------------------------- K13: DMA probe


def _dma_blocks(data, depth):
    """The blocks the walk covers: whole groups of ``depth``."""
    if data.dim() != 3 or data.dtype not in _DTYPES:
        raise ValueError(f"expected data [nblocks, d, blk] int8 or bfloat16, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    return (data.shape[0] // depth) * depth


def _dma_probe_reference(x, data, depth):
    """Plain K13 → [1] f32: the max over the first (nblocks // depth) ·
    depth blocks (-inf for none), plus ``sum(x) · 0`` as the JAX function
    adds."""
    n = _dma_blocks(data, depth)
    if n:
        m = data[:n].amax().to(torch.float32).reshape(1)
    else:
        m = torch.full((1,), float("-inf"), dtype=torch.float32, device=data.device)
    return m + x.sum() * 0


def _dma_probe(x, data, depth):
    """K13 with the JAX signature → [1] f32; see :func:`_dma_probe_reference`.
    On the card, one CTA per SM walks a contiguous run of 16 KB slices of
    the blocks JAX's ``depth`` picks through a ring of ``min(depth, 8)``
    shared-memory stages filled by ``cp.async.bulk`` and completed on
    mbarriers; the walk's tail past its last 16-byte piece (blocks of any
    size) is read with ordinary loads."""
    n = _dma_blocks(data, depth)
    dev = data.device
    if dev.type == "cpu":
        if x.device != dev:
            raise ValueError("all K13 inputs must be on one device")
        return _dma_probe_reference(x, data, depth)
    _build.check_inputs("K13", dev, [x, data])
    _, d, blk = data.shape
    block_bytes = d * blk * data.element_size()
    data = _build.aligned(data, 16)
    partial = torch.empty(_sms(dev), dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    fn = _kernel("hw_dma_probe", 3, 3, longlong=True)
    _launch("K13", "hw_dma_probe", dev, fn, data, partial, out,
            n * block_bytes, min(depth, _MAX_RING), int(data.dtype == torch.bfloat16),
            kernels=2 if n else 1)
    return out + x.sum() * 0


# ----------------------------------------------------- K14: GEMM rate probe


def _gemm_rate_check(q, v, g, tb, tn, unit):
    if unit not in UNITS:
        raise ValueError(f"unknown unit {unit!r}; one of {UNITS}")
    if q.dim() != 2 or v.dim() != 2 or q.shape[1] != v.shape[0]:
        raise ValueError(f"expected q [tb, d] and v [d, tn], got {tuple(q.shape)} and "
                         f"{tuple(v.shape)}")
    if q.dtype != v.dtype or q.dtype not in _DTYPES:
        raise ValueError(f"expected int8 or bfloat16 operands of one dtype, got {q.dtype} "
                         f"and {v.dtype}")
    if unit == "dp4a" and q.dtype != torch.int8:
        raise ValueError("the dp4a unit takes int8")
    if q.shape[0] < tb or v.shape[1] < tn or g < 1:
        raise ValueError(f"need q rows >= tb={tb}, v columns >= tn={tn} and g >= 1")
    # The JAX BlockSpecs take the first [tb, d] of q and [d, tn] of v.
    return q[:tb], v[:, :tn].contiguous()


def _twisted_q(q, steps, acc):
    """q as each step's product sees it → [len(steps), tb, d] in ``acc``:
    int8 with row (i % tb) set to 1; bf16 times bf16(1 + i), rounded to
    bf16 before the product."""
    tb = q.shape[0]
    if q.dtype == torch.int8:
        qx = q.to(acc).expand(len(steps), *q.shape).clone()
        one = torch.ones((), dtype=acc, device=q.device)  # on the device: graph-capturable
        qx[torch.arange(len(steps), device=q.device), steps % tb] = one
        return qx
    scale = (1 + steps).to(torch.float32).to(torch.bfloat16)
    return (q[None] * scale[:, None, None]).to(acc)


def _gemm_rate_steps_reference(q, v, g, tb, tn, sel, unit="mma"):
    """Plain K14's every step → [g] f32: the max of each step's product
    (twisted q @ v, int8 exactly at any d, bf16 → f32; ``sel`` takes the
    row maxima first, as the JAX kernel does, and changes no value;
    ``unit`` picks the card's unit and changes no value)."""
    q, v = _gemm_rate_check(q, v, g, tb, tn, unit)
    acc = _ACC[q.dtype]
    va = v.to(acc)
    per = max(1, _CHUNK // (tb * tn))
    maxes = []
    for s in range(0, g, per):
        steps = torch.arange(s, min(g, s + per), device=q.device)
        scores = torch.matmul(_twisted_q(q, steps, acc), va)
        maxes.append(scores.amax(dim=2).amax(dim=1) if sel else scores.amax(dim=(1, 2)))
    return torch.cat(maxes).to(torch.float32)


def _gemm_rate_probe_reference(x, q, v, g, tb, tn, sel, unit="mma"):
    """Plain K14 → [1] f32: the max of the last step's product, plus
    ``sum(x) · 0``.  Every step's product is computed, as the kernel does
    (:func:`_gemm_rate_steps_reference`)."""
    return _gemm_rate_steps_reference(q, v, g, tb, tn, sel, unit)[-1:] + x.sum() * 0


def _gemm_rate_launch(q, v, g, tb, tn, sel, unit, fill):
    """K14's kernels on the card → (out [1], the last step's max; sink [g,
    units·8], each step's max per 128 x 128 unit and warp, in a buffer made
    by ``fill``)."""
    q, v = _gemm_rate_check(q, v, g, tb, tn, unit)
    dev = q.device
    _build.check_inputs("K14", dev, [q, v])
    # The kernels read K in 4-byte words: d padded to a multiple of 4 bytes
    # with zeros in q's columns and v's rows (zero terms move no product;
    # the int8 twist sets a row's pad to 1, against v's zero rows).
    es = q.element_size()
    q = _build.pad_rows(q, 4 // es)
    if q.shape[1] != v.shape[0]:
        v = torch.cat([v, v.new_zeros((q.shape[1] - v.shape[0], v.shape[1]))])
    d = q.shape[1]
    q, v = _build.aligned(q, 4), _build.aligned(v, 4)
    units = -(-tb // 128) * -(-tn // 128)
    # CTAs per unit that fill the card once with the CTAs an SM holds:
    # the wgmma kernel one (its two accumulator sets and resident A take
    # over 128 registers a thread), the dp4a kernel two.
    reps = max(1, (1 if unit == "mma" else 2) * _sms(dev) // units)
    sink = fill(g * units * 8, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    fn = _kernel("hw_gemm_rate_probe", 4, 8)
    _launch("K14", "hw_gemm_rate_probe", dev, fn, q, v, sink, out, tb, tn, d, g, reps,
            int(bool(sel)), int(q.dtype == torch.bfloat16), int(unit == "dp4a"), kernels=2)
    return out, sink.view(g, units * 8)


def _gemm_rate_probe(x, q, v, g, tb, tn, sel, unit="mma"):
    """K14 with the JAX signature (and ``unit``, "mma" or "dp4a") → [1]
    f32; see :func:`_gemm_rate_probe_reference`.  On the card each CTA
    holds one 128 x 128 unit of the product (a row tile of q, a column tile
    of v, whole K) resident and takes every R-th step, R = the CTAs per
    unit that fill the card once with the CTAs an SM holds ("mma":
    ``wgmma`` with A in registers, one CTA an SM; "dp4a": two); every
    step's product is computed once across the card, and each warp writes
    its max of it."""
    if q.device.type == "cpu":
        if v.device != q.device or x.device != q.device:
            raise ValueError("all K14 inputs must be on one device")
        return _gemm_rate_probe_reference(x, q, v, g, tb, tn, sel, unit)
    _build.check_inputs("K14", q.device, [x])
    return _gemm_rate_launch(q, v, g, tb, tn, sel, unit, _empty)[0] + x.sum() * 0


def _gemm_rate_steps(q, v, g, tb, tn, sel, unit="mma"):
    """Every step's max → [g] f32: on the card the kernel's whole sink
    reduced over units and warps, NaN where no CTA wrote; on the CPU the
    plain version."""
    if q.device.type == "cpu":
        return _gemm_rate_steps_reference(q, v, g, tb, tn, sel, unit)
    return _gemm_rate_launch(q, v, g, tb, tn, sel, unit, _nans)[1].amax(dim=1)


# -------------------------------------------------------------- the probes


def _rand(shape, dtype, gen, dev):
    """Seeded operands made on the device: int8 in [-127, 126] (the JAX
    range), bf16 standard normal drawn in bf16 (no float32 copy)."""
    if dtype == torch.int8:
        return torch.randint(-127, 127, shape, generator=gen, device=dev, dtype=torch.int8)
    return torch.randn(shape, generator=gen, device=dev, dtype=dtype)


def _planted_walk(nblocks, d, blk, fat, dtype, gen):
    """Check data for K12 → (data [nblocks, d, blk], each step's max [g]
    f32): every step of ``fat`` blocks holds one planted value, at a seeded
    position, above a bulk that stays below all of them (int8: -100 +
    (37·s mod 226) over a bulk in [-127, -101], so neighbouring steps
    differ and any 226 in a row are distinct; bf16: distinct values from 8
    up in a seeded order over a normal bulk clamped to [-7.5, 7.5]); one
    earlier step also holds a decoy, the walk's largest value, so that the
    last step's max is not the walk's."""
    g = nblocks // fat
    per = fat * d * blk
    dev = gen.device
    steps = torch.arange(g, device=dev)
    if dtype == torch.int8:
        data = torch.randint(-127, -100, (g, per), generator=gen, device=dev, dtype=dtype)
        top = (-100 + (37 * steps) % 226).to(dtype)
        decoy = torch.tensor(127, dtype=dtype, device=dev)
    else:
        if 0x4100 + g >= 0x7F80:
            raise ValueError(f"too many steps for distinct finite bf16 maxima: {g}")
        data = torch.randn((g, per), generator=gen, device=dev, dtype=dtype).clamp_(-7.5, 7.5)
        order = torch.randperm(g, generator=gen, device=dev)
        top = (0x4100 + order).to(torch.int16).view(dtype)
        decoy = torch.tensor(0x4100 + g, dtype=torch.int16, device=dev).view(dtype)
    pos = torch.randint(per, (g,), generator=gen, device=dev)
    data[steps, pos] = top
    if g > 1:
        s = int(torch.randint(g - 1, (1,), generator=gen, device=dev))
        data[s, (pos[s] + 1) % per] = decoy
        top[s] = decoy
    return data.view(nblocks, d, blk), top.to(torch.float32)


def _sec(fn, dev, repeats) -> float:
    """Seconds per call: on the card, device time of ``repeats`` calls
    captured in one CUDA graph (the wrapper's ~30 µs of Python a call
    would otherwise hide the small probes' device time); on the CPU, the
    host clock."""
    if dev.type == "cuda":
        return _graph_ms(fn, dev, repeats) / 1e3
    return timing.per_call_ms(fn, [dev], calls=repeats) / 1e3


def _mm_f32(a, b):
    """bf16 x bf16 → f32 in one call (``out_dtype``, CUDA); this CPU build
    has no such kernel, so there the product is taken in f32."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


XLA_GEMMS = ((1024, 4096, 4096, torch.bfloat16), (4096, 4096, 4096, torch.bfloat16),
             (1024, 4096, 4096, torch.int8), (4096, 4096, 4096, torch.int8),
             (2048, 128, 16384, torch.int8))  # the last search-shaped: K = D = 128


def probe_xla(repeats=8, device="cuda", gemms=XLA_GEMMS, nbytes=1 << 30):
    """GEMM TOPS and 1 GiB reduce / copy GB/s through plain torch ops."""
    print("== XLA-op ceilings (plain torch ops, no hand-written kernel) ==")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"gemm": {}, "reduce": {}, "copy": {}}
    for m, k, n, dt in gemms:
        a, b = _rand((m, k), dt, gen, dev), _rand((k, n), dt, gen, dev)
        if dt == torch.int8:  # int8 torch.mm wraps: _int_mm accumulates in int32
            fn = lambda a=a, b=b: torch.sum(torch._int_mm(a, b), dtype=torch.float32)  # noqa: E731
        else:
            fn = lambda a=a, b=b: torch.sum(_mm_f32(a, b), dtype=torch.float32)  # noqa: E731
        sec = _sec(fn, dev, repeats)
        tops = 2 * m * k * n / sec / 1e12
        out["gemm"][m, k, n, _NAMES[dt]] = tops
        print(f"  gemm {m}x{k}x{n} {_NAMES[dt]:<9} {sec*1e3:8.3f} ms  {tops:8.2f} TOPS")
        del a, b
    v = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    for dt in (torch.int8, torch.bfloat16, torch.float32):
        big = torch.zeros(nbytes // dt.itemsize, dtype=dt, device=dev)
        sec = _sec(lambda: torch.sum(big, dtype=torch.float32) + v.sum(), dev, repeats)
        out["reduce"][_NAMES[dt]] = nbytes / sec / 1e9
        print(f"  reduce 1GiB {_NAMES[dt]:<9} {sec*1e3:8.3f} ms  {nbytes/sec/1e9:8.1f} GB/s read")
        # read + write the array; the first element's sum ties the output in.
        sec = _sec(lambda: torch.sum((big + v[0, 0].to(dt))[:1], dtype=torch.float32), dev,
                   repeats)
        out["copy"][_NAMES[dt]] = 2 * nbytes / sec / 1e9
        print(f"  copy   1GiB {_NAMES[dt]:<9} {sec*1e3:8.3f} ms  {2*nbytes/sec/1e9:8.1f} GB/s r+w")
        del big
    return out


def probe_pallas_step(repeats=8, device="cuda", grids=(256, 1024, 4096)):
    """K11's per-step slope for each semantics, pinned and moving; then the
    cost of one launch of the one-step kernel, eager and in a CUDA graph."""
    print("== per-grid-step floor (trivial kernel K11) ==")
    dev = torch.device(device)
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    lo, hi = grids[0], grids[-1]
    out = {"slope_us": {}, "launch_us": {}}
    for semantics in SEMANTICS:
        for moving in (False, True):
            times = {g: _sec(lambda g=g: _step_probe(x, g, moving, semantics), dev, repeats)
                     for g in grids}
            slope = (times[hi] - times[lo]) / (hi - lo)
            out["slope_us"][semantics, moving] = slope * 1e6
            print(f"  semantics={semantics!s:<10} moving={moving!s:<6}"
                  f" t({lo})={times[lo]*1e3:7.3f} ms t({hi})={times[hi]*1e3:7.3f} ms"
                  f"  slope={slope*1e6:6.3f} us/step")

    def one():
        return _step_probe(x, 1, False, "parallel")

    def launches():
        for _ in range(hi):
            one()

    out["launch_us"]["eager"] = timing.per_call_ms(launches, [dev], calls=repeats) * 1e3 / hi
    line = (f"  launch: {hi} launches of the one-step kernel,"
            f" eager {out['launch_us']['eager']:7.3f} us")
    if dev.type == "cuda":
        out["launch_us"]["graph"] = _graph_ms(one, dev, hi) * 1e3
        line += f", graphed {out['launch_us']['graph']:7.3f} us a launch"
    else:
        out["launch_us"]["graph"] = None
        line += ", graphed not measured (CUDA graphs need a CUDA device)"
    print(line)
    return out


def probe_pallas_stream(repeats=6, device="cuda", total=512 << 20, blks=(2048, 8192), d=128):
    """K12 over a ``total``-byte walk per dtype and block width, fat 1 and
    4, with and without the product, semantics None and "arbitrary"."""
    print("== streaming (512 MB walk, per-variant; kernel K12) ==")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dt in _DTYPES:
        isz = dt.itemsize
        for blk in blks:
            nblocks = total // (d * blk * isz)
            nblocks -= nblocks % 16
            data = _rand((nblocks, d, blk), dt, gen, dev)
            x = _rand((128, d), dt, gen, dev)
            for fat in (1, 4):
                if 2 * fat * d * blk * isz > 12 << 20:
                    continue  # the TPU's double-buffered window would blow VMEM
                for gemm in (False, True):
                    for semantics in (None, "arbitrary"):
                        sec = _sec(lambda: _stream_probe(x, data, blk, fat, gemm, semantics),
                                   dev, repeats)
                        nb = nblocks * d * blk * isz
                        us_step = sec / (nblocks // fat) * 1e6
                        out[_NAMES[dt], blk, fat, gemm, semantics] = nb / sec / 1e9
                        print(f"  {_NAMES[dt]:<8} blk={blk:<5} fat={fat}"
                              f" gemm={int(gemm)} sem={semantics!s:<9}"
                              f" {sec*1e3:8.2f} ms  {nb/sec/1e9:7.1f} GB/s"
                              f"  {us_step:6.2f} us/step")
            del data
    return out


DMA_CASES = ((torch.int8, 2048), (torch.int8, 8192), (torch.bfloat16, 2048))


def probe_pallas_dma(repeats=6, device="cuda", total=2 << 30, cases=DMA_CASES,
                     depths=(1, 4, 8), d=128):
    """MARGINAL bandwidth of K13: a full and a quarter walk of the same
    array, the byte delta over the time delta, so that fixed costs drop
    out."""
    print("== multi-copy streaming (marginal GB/s; kernel K13) ==")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    xf = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    out = {}
    for dt, blk in cases:
        isz = dt.itemsize
        nblocks = total // (d * blk * isz)
        nblocks -= nblocks % 64
        data = _rand((nblocks, d, blk), dt, gen, dev)
        small = data[: nblocks // 4]
        for depth in depths:
            if depth * d * blk * isz > 12 << 20:
                continue
            t_full = _sec(lambda: _dma_probe(xf, data, depth), dev, repeats)
            t_quarter = _sec(lambda: _dma_probe(xf, small, depth), dev, repeats)
            db = (nblocks - nblocks // 4) * d * blk * isz
            gbs = db / max(t_full - t_quarter, 1e-9) / 1e9
            out[_NAMES[dt], blk, depth] = gbs
            print(f"  {_NAMES[dt]:<8} blk={blk:<5} depth={depth}"
                  f" full={t_full*1e3:8.2f} ms quarter={t_quarter*1e3:8.2f} ms"
                  f"  marginal {gbs:7.1f} GB/s")
        del data, small
    return out


GEMM_SHAPES = ((128, 2048), (256, 2048), (512, 2048), (256, 5632), (1024, 2048), (256, 1024))


def probe_pallas_gemm(repeats=6, device="cuda", shapes=GEMM_SHAPES, gs=(512, 2048), d=128,
                      units=UNITS):
    """K14's in-kernel matrix rate (no device-memory traffic per step: the
    operands stay resident), as a slope between two step counts; int8 on
    each unit in ``units`` (rows past the tensor cores' marked
    ``unit=dp4a``)."""
    print("== in-kernel GEMM rate (slope; kernel K14) ==")
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    xf = torch.zeros((8, 128), dtype=torch.float32, device=dev)
    lo, hi = gs[0], gs[-1]
    out = {}
    for dt in _DTYPES:
        for tb, tn in shapes:
            q, v = _rand((tb, d), dt, gen, dev), _rand((d, tn), dt, gen, dev)
            for unit in (units if dt == torch.int8 else ("mma",)):
                ts = {g: _sec(lambda g=g: _gemm_rate_probe(xf, q, v, g, tb, tn, False, unit),
                              dev, repeats) for g in (lo, hi)}
                slope = (ts[hi] - ts[lo]) / (hi - lo)
                tops = 2 * tb * d * tn / max(slope, 1e-12) / 1e12
                out[_NAMES[dt], tb, tn, unit] = tops
                line = (f"  {_NAMES[dt]:<8} [{tb:>4}x{d}]x[{d}x{tn:>5}]"
                        f"  {slope*1e6:7.2f} us/step  {tops:7.1f} TOPS")
                print(line + ("" if unit == "mma" else f"  unit={unit}"))
    return out


PROBES = {
    "xla": probe_xla,
    "pallas_step": probe_pallas_step,
    "pallas_stream": probe_pallas_stream,
    "pallas_dma": probe_pallas_dma,
    "pallas_gemm": probe_pallas_gemm,
}


def main(argv=None):
    """Run the chosen probes on the card at the JAX sizes → {probe: its
    result dict}.  Raises without a CUDA device: these are measurements."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--probes", nargs="+", default=list(PROBES), choices=list(PROBES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hw_probe measures the card, and torch sees no CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return {p: PROBES[p]() for p in args.probes}


if __name__ == "__main__":
    main()
