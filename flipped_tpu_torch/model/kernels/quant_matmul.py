"""K3, K7 and K4: the int8 GEMMs of the quantized frozen backbone.

- K3 `int8_fwd` replaces the TPU kernel `int8_fwd_pallas` → `_fwd_kernel`
  (flipped_tpu/model/pallas/quant_matmul.py:603-698); CUDA source
  csrc/int8_fwd.cu, and csrc/int8_decode.cu for x of at most DECODE_MAX_M
  rows (generation's decode steps, the adapter prefix). Per-row absmax
  round-to-nearest-even quantize of x (scale amax·float32(1/127), a
  reciprocal multiply), int8×int8→int32, then (d·xs)·scale rounded to
  x.dtype: the w8a8 per-channel forward.
- K7 `grouped_matmul` replaces `grouped_matmul_pallas` → `_kernel`
  (:55-145); CUDA source csrc/int8_grouped_fwd.cu, and csrc/int8_decode.cu
  for x of at most DECODE_MAX_M rows. Per-(row, 128-group)
  quantize with scale amax/127 (a division), one int32 dot per group and
  an f32 sum Σ_g (d_g·xs_g)·s_g taken over the groups in order: the
  w8a8g/w8a8o forward.
- K4 `quant_dx` replaces `quant_dx_pallas` → `_dx_kernel` (:316-406); CUDA
  source csrc/quant_dx.cu. dx = g·dequant(W)ᵀ with W = bf16(kq)·bf16(s_g),
  f32 accumulation, rounded through bf16: the w8a8g/w8a8o backward.

- K8 `int4_matmul` replaces `int4_matmul_grouped_pallas` → `_int4_kernel`
  (:160-275); CUDA source csrc/int4_fwd.cu, and csrc/int4_decode.cu for x
  of at most DECODE_MAX_M rows at group 128 (generation's decode steps, the
  adapter prefix). act_quant=True (w4a8) is K7 on the unpacked codes;
  act_quant=False (int4) runs bf16 products on the raw codes and scales
  each group's partial product: Σ_g d_g·s_g in f32, the groups in order.
- K9 `int4_dx` replaces `int4_dx_pallas` → `_int4_dx_kernel` (:701-766);
  CUDA source csrc/int4_dx.cu: K4 on the unpacked codes.
- K10 `int8_dgrad` replaces `int8_dgrad_pallas` → `_dgrad_kernel`
  (:449-562); CUDA source csrc/int8_dgrad.cu. The w8a8d dx: the cotangent
  times the weight scale, per-row absmax, stochastic rounding to int8 with
  the murmur dither (JAX: int8.py:154-209), an int8 GEMM over N, times the
  row scale.

Operands are in the port's layout (ckpt/quantize.py): kq (N, K) int8,
kq4 (N/2, K) packed int4 (byte [j, k] holds W[j, k] in its low nibble and
W[j + N/2, k] in its high nibble), scale (N,) or scale_g (G, N) f32,
x (..., K), g (..., N).

For each wrapper:
- a CUDA tensor launches the kernel, or the wrapper raises: there is no
  fallback to the plain version;
- a CPU tensor takes the plain version (`int8_fwd_ref`, `grouped_matmul_ref`,
  `quant_dx_ref`, `int4_matmul_ref`, `int4_dx_ref`, `int8_dgrad_ref`), which
  is what the CPU tests hold against the JAX package;
- `<wrapper>.launches` counts kernel launches; only the CUDA branch adds
  to it. `int8_fwd`, `grouped_matmul` and `int4_matmul` count their two
  routes apart (`takes_decode_route`): `launches` the calls that launch
  the kernels of more rows (int8_fwd.cu, int8_grouped_fwd.cu,
  int4_fwd.cu), `decode_launches` those that launch the decode route's
  (int8_decode.cu, int4_decode.cu).

The plain versions compute each int8 dot exactly, as a float64 product of
integers (|Σ| ≤ 127²·K < 2^53; an f32 sum is not exact above K ≈ 1040), so
on the card K3, K7, K8's w4a8 branch and K10 are held to them bit for bit.
Their divisors are tensors: PyTorch divides a CUDA tensor by a Python
scalar as a multiply by its reciprocal, which is not the division K7 (and
JAX's formulation) does. K8's weight-only branch, K4 and K9 sum bf16
products in f32 in the tensor cores' order, and are held to their plain
versions within the error bounds chip_smoke.py states (K4_REL, K8_WO_REL).
"""
from __future__ import annotations

import torch

EPS = 1e-8                    # scale floor: all-zero rows quantize to 0
INV127 = float.fromhex("0x1.020408p-7")  # float32(1/127), exact in f32
GROUP = 128                   # the group width K7 and K4 are built for
MASK32 = 0xFFFFFFFF
# K3, K7 and K8 take their decode routes (csrc/int8_decode.cu,
# csrc/int4_decode.cu) up to this many rows of x (K8 at the model's group
# of 128; other groups take int4_fwd.cu)
DECODE_MAX_M = 64
# K3's and K8 weight-only's decode routes cut the contraction into runs
# until their 64-column tiles times the runs reach this many blocks (the
# H100's SMs)
DECODE_FILL = 132
# K3's decode route: the contraction of one of its pipeline stages, the
# least a run takes, and the most runs (a tile's runs are one thread-block
# cluster, at most the portable cluster size)
DECODE_STAGE = 256
DECODE_MAX_RUNS = 8


def _lead(x: torch.Tensor):
    k = x.shape[-1]
    return x.shape[:-1], x.reshape(-1, k)


def quantize_act(x: torch.Tensor):
    """(..., K) float → (xq (..., K) f32 integer codes in [-127, 127],
    xs (..., 1) f32): per-row absmax RTN with the reciprocal multiply
    (JAX: int8.py:57-69, `_quantize_act`)."""
    x32 = x.float()
    amax = x32.abs().amax(-1, keepdim=True)
    xs = torch.clamp_min(amax * INV127, EPS)
    return torch.round(x32 / xs), xs


def quantize_groups(x: torch.Tensor, groups: int):
    """(M, K) float → (xq (M, G, K/G) f32 codes, xs (M, G, 1) f32): per
    (row, group) absmax RTN with the scale amax/127 as a division
    (JAX: int8.py:255-258)."""
    m, k = x.shape
    x32 = x.float().reshape(m, groups, k // groups)
    amax = x32.abs().amax(-1, keepdim=True)
    xs = torch.clamp_min(amax / torch.full_like(amax, 127.0), EPS)
    return torch.round(x32 / xs), xs


def _exact_dot(xq: torch.Tensor, kq: torch.Tensor) -> torch.Tensor:
    """Σ_k xq[m, k]·kq[n, k] of integer codes, exact in float64, → f32
    (the int32 → f32 rounding of the kernels)."""
    return (xq.double() @ kq.double().t()).float()


def int8_fwd_ref(x, kq, scale):
    """Plain K3: x (..., K) float, kq (N, K) int8, scale (N,) f32 →
    (..., N) x.dtype (JAX: int8.py:72-77, `_int8_matmul_fwd_impl`)."""
    lead, x2 = _lead(x)
    xq, xs = quantize_act(x2)
    out = (_exact_dot(xq, kq) * xs) * scale
    return out.reshape(*lead, kq.shape[0]).to(x.dtype)


def grouped_matmul_ref(x, kq, scale_g):
    """Plain K7: x (..., K) float, kq (N, K) int8, scale_g (G, N) f32 →
    (..., N) x.dtype. The groups are summed in order into one (M, N) f32
    accumulator, as `_grouped_matmul_scan` does (JAX: int8.py:414-444):
    never the (G, M, N) intermediate of the batched formulation."""
    lead, x2 = _lead(x)
    groups = scale_g.shape[0]
    xq, xs = quantize_groups(x2, groups)
    n, k = kq.shape
    kg = kq.reshape(n, groups, k // groups)
    acc = torch.zeros(x2.shape[0], n, dtype=torch.float32, device=x.device)
    for gi in range(groups):
        acc = acc + (_exact_dot(xq[:, gi], kg[:, gi]) * xs[:, gi]) \
            * scale_g[gi]
    return acc.reshape(*lead, n).to(x.dtype)


def dequant(kq, scale, dtype):
    """The (N, K) weight dtype(kq)·dtype(scale), scale (N,) per-channel or
    (G, N) grouped — in bf16 the rounding of the JAX weight-only and dx
    formulations (int8.py:122, 389-390; llama.py:149-152, 161)."""
    if scale.dim() == 1:
        return kq.to(dtype) * scale.to(dtype)[:, None]
    n, k = kq.shape
    groups = scale.shape[0]
    return (kq.reshape(n, groups, k // groups).to(dtype)
            * scale.t()[:, :, None].to(dtype)).reshape(n, k)


def quant_dx_ref(g, kq, scale_g):
    """Plain K4: g (..., N) float, kq (N, K) int8, scale_g (G, N) f32 →
    dx (..., K) g.dtype = bf16(g)·W, W the bf16 dequantized weight
    (JAX: int8.py:384-391, `_dx_grouped_xla`)."""
    w = dequant(kq, scale_g, torch.bfloat16)
    return (g.to(torch.bfloat16) @ w).to(g.dtype)


def unpack_int4(kq4: torch.Tensor) -> torch.Tensor:
    """(N/2, K) packed int8 → (N, K) int8 codes in [-8, 7]: the low
    nibbles are rows [0, N/2), the high nibbles rows [N/2, N), each
    sign-extended (JAX: int4.py:60-64, transposed)."""
    p = kq4.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = (((p >> 4) & 0xF) ^ 8) - 8
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def int4_matmul_ref(x, kq4, scale_g, act_quant: bool):
    """Plain K8: x (..., K) float, kq4 (N/2, K) packed, scale_g (G, N) f32
    → (..., N) x.dtype. act_quant: `grouped_matmul_ref` on the unpacked
    codes. Weight-only: each group's product of bf16(x) and the codes,
    exact in float64 and rounded once to f32, times s_g, the groups added
    in order into one f32 accumulator (JAX: quant_matmul.py:195-210)."""
    w = unpack_int4(kq4)
    if act_quant:
        return grouped_matmul_ref(x, w, scale_g)
    lead, x2 = _lead(x)
    n, k = w.shape
    groups = scale_g.shape[0]
    gw = k // groups
    xb = x2.to(torch.bfloat16).double()
    acc = torch.zeros(x2.shape[0], n, dtype=torch.float32, device=x.device)
    for gi in range(groups):
        sl = slice(gi * gw, (gi + 1) * gw)
        d = (xb[:, sl] @ w[:, sl].double().t()).float()
        acc = acc + d * scale_g[gi]
    return acc.reshape(*lead, n).to(x.dtype)


def int4_dx_ref(g, kq4, scale_g):
    """Plain K9: g (..., N) float, kq4 (N/2, K), scale_g (G, N) f32 → dx
    (..., K) g.dtype: `quant_dx_ref` on the unpacked codes (JAX: int4.py:
    128-130, `_int4_dx_xla`)."""
    return quant_dx_ref(g, unpack_int4(kq4), scale_g)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """h·c mod 2^32 for int64 h in [0, 2^32): c in 16-bit halves, so no
    product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def dither(x2: torch.Tensor, s_mod: int) -> torch.Tensor:
    """u in [0, 1) for each element of x2 (M, N) f32: the murmur mix of its
    float32 bits, its column n and its row m % s_mod, in uint32 arithmetic
    emulated in int64 (JAX: int8.py:164-176)."""
    m, n = x2.shape
    h = x2.contiguous().view(torch.int32).to(torch.int64) & MASK32
    col = torch.arange(n, dtype=torch.int64, device=x2.device)
    row = torch.arange(m, dtype=torch.int64, device=x2.device) % s_mod
    h = h ^ ((col * 0x9E3779B9) & MASK32)[None, :]
    h = h ^ ((row * 0x85EBCA6B) & MASK32)[:, None]
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * 2.0 ** -32


def sr_codes(x2: torch.Tensor, s_mod: int) -> torch.Tensor:
    """Stochastic rounding of x2 (M, N) f32 to int8 codes held as f32:
    floor(x) + (frac(x) > u), saturated to [-128, 127] as JAX's float →
    int8 conversion does (a value of 127.00001 can round up to 128)."""
    fl = torch.floor(x2)
    q = fl + ((x2 - fl) > dither(x2, s_mod)).to(torch.float32)
    return torch.clamp(q, -128.0, 127.0)


def int8_dgrad_ref(g, kq, scale, s_mod: int):
    """Plain K10: g (..., N) float, kq (N, K) int8, scale (N,) f32, the
    dither's row period s_mod → dx (..., K) g.dtype (JAX: int8.py:186-209,
    `_dgrad_dx_xla`): gs = f32(g)·s, gsc = max(amax_row(gs)·f32(1/127),
    1e-8), codes = SR(gs/gsc), dx = (Σ_n codes·kq, exact)·gsc."""
    lead, g2 = _lead(g)
    gs = g2.float() * scale
    amax = gs.abs().amax(-1, keepdim=True)
    gsc = torch.clamp_min(amax * INV127, EPS)
    gq = sr_codes(gs / gsc, s_mod)
    out = _exact_dot(gq, kq.t()) * gsc
    return out.reshape(*lead, kq.shape[1]).to(g.dtype)


def _check(name, checks):
    for ok, msg in checks:
        if not ok:
            raise ValueError(f"{name}: {msg}")


def _check_common(name, a, kq, scale, a_dim, scale_shape):
    """a is x (its last dim K) or g (its last dim N)."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes a bf16 activation, got {a.dtype}")
    if kq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{name} takes int8 kq and f32 scales, got "
                        f"{kq.dtype} and {scale.dtype}")
    n, k = kq.shape if kq.dim() == 2 else (-1, -1)
    _check(name, [
        (kq.dim() == 2, f"kq must be (N, K), got {tuple(kq.shape)}"),
        (a.shape[-1] == (k if a_dim == "K" else n),
         f"activation {tuple(a.shape)} does not match kq (N, K) = "
         f"{tuple(kq.shape)}"),
        (tuple(scale.shape) == scale_shape(n, k),
         f"scale {tuple(scale.shape)} != {scale_shape(n, k)}"),
        (all(t.device == a.device for t in (kq, scale)),
         f"operands on {a.device}, {kq.device}, {scale.device}"),
        (all(t.is_contiguous() for t in (a, kq, scale)),
         "activation, kq and scale must be contiguous"),
        (a.numel() > 0, "empty activation"),
        (a.data_ptr() % 16 == 0 and kq.data_ptr() % 16 == 0,
         "activation and kq must be 16-byte aligned"),
        (n % 8 == 0 and k % 16 == 0,
         f"needs N % 8 == 0 and K % 16 == 0, got N {n}, K {k}")])
    return n, k


def _tma_aligned(scale_g):
    """K4, K7, K8 w4a8 and K9 load their scales by TMA: a 16-byte aligned
    source."""
    return (scale_g.data_ptr() % 16 == 0,
            "scale_g must be 16-byte aligned (the kernel loads it by TMA)")


def _row_scales(m, groups, device):
    """K7's and K8 w4a8's scratch for the row scales, which their quantize
    pass writes transposed: (groups, M rounded up to 4) f32, so that one
    group's scales of a tile are one contiguous TMA box (csrc/quant_common.cuh
    `xs_pitch`)."""
    return torch.empty((groups, -(-m // 4) * 4), dtype=torch.float32,
                       device=device)


def _launch(fn, *args):
    from .build import build

    lib = build()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib.lib, fn)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {lib.error_string(err)} "
                           f"(cudaError {err})")


def _device_ok(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got "
                         f"{t.device}")


def takes_decode_route(m: int, group: int = GROUP) -> bool:
    """Whether a call of x with m rows (grouped scales of width `group`)
    takes the decode route of K3, K7 or K8: at most DECODE_MAX_M rows, at
    group 128 (K3 has no groups)."""
    return m <= DECODE_MAX_M and group == GROUP


def int8_decode_splits(n: int, k: int) -> int:
    """Runs K3's decode route cuts the contraction into, each a block: as
    many as bring its 64-column tiles times the runs to DECODE_FILL blocks,
    at most one a DECODE_STAGE-deep stage of K and at most DECODE_MAX_RUNS
    (its int32 sums are exact in any order)."""
    tiles = -(-n // 64)
    return max(1, min(-(-k // DECODE_STAGE), DECODE_MAX_RUNS,
                      DECODE_FILL // tiles))


def int8_fwd(x, kq, scale):
    """K3, w8a8 per-channel forward: x (..., K), kq (N, K) int8, scale (N,)
    f32 → (..., N) in x.dtype. x of at most DECODE_MAX_M rows takes the
    decode route."""
    if x.device.type == "cpu":
        return int8_fwd_ref(x, kq, scale)
    _device_ok("int8_fwd", x)
    n, k = _check_common("int8_fwd", x, kq, scale, "K",
                         lambda n, k: (n,))
    lead, x2 = _lead(x)
    m = x2.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        if takes_decode_route(m):
            _launch("int8_decode", x2.data_ptr(), kq.data_ptr(),
                    scale.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                    out.data_ptr(), m, n, k, int8_decode_splits(n, k))
            int8_fwd.decode_launches += 1
        else:
            _launch("int8_fwd", x2.data_ptr(), kq.data_ptr(),
                    scale.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                    out.data_ptr(), m, n, k)
            int8_fwd.launches += 1
    return out.reshape(*lead, n)


int8_fwd.launches = 0
int8_fwd.decode_launches = 0


def grouped_matmul(x, kq, scale_g):
    """K7, w8a8 grouped forward: x (..., K), kq (N, K) int8, scale_g
    (K/128, N) f32 → (..., N) in x.dtype. x of at most DECODE_MAX_M rows
    takes the decode route."""
    if x.device.type == "cpu":
        return grouped_matmul_ref(x, kq, scale_g)
    _device_ok("grouped_matmul", x)
    n, k = _check_common("grouped_matmul", x, kq, scale_g, "K",
                         lambda n, k: (k // GROUP, n))
    _check("grouped_matmul", [(k % GROUP == 0,
                               f"needs K % {GROUP} == 0, got {k}"),
                              _tma_aligned(scale_g)])
    lead, x2 = _lead(x)
    m = x2.shape[0]
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = _row_scales(m, k // GROUP, x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    decode = takes_decode_route(m)
    with torch.cuda.device(x.device):
        _launch("int8_grouped_decode" if decode else "int8_grouped_fwd",
                x2.data_ptr(), kq.data_ptr(), scale_g.data_ptr(),
                xq.data_ptr(), xs.data_ptr(), out.data_ptr(), m, n, k)
    if decode:
        grouped_matmul.decode_launches += 1
    else:
        grouped_matmul.launches += 1
    return out.reshape(*lead, n)


grouped_matmul.launches = 0
grouped_matmul.decode_launches = 0


def quant_dx(g, kq, scale_g):
    """K4, the grouped backward: g (..., N), kq (N, K) int8, scale_g
    (K/128, N) f32 → dx (..., K) in g.dtype."""
    if g.device.type == "cpu":
        return quant_dx_ref(g, kq, scale_g)
    _device_ok("quant_dx", g)
    n, k = _check_common("quant_dx", g, kq, scale_g, "N",
                         lambda n, k: (k // GROUP, n))
    _check("quant_dx", [(k % GROUP == 0, f"needs K % {GROUP} == 0, got {k}"),
                        _tma_aligned(scale_g)])
    lead, g2 = _lead(g)
    m = g2.shape[0]
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=g.device)
    with torch.cuda.device(g.device):
        _launch("quant_dx", g2.data_ptr(), kq.data_ptr(),
                scale_g.data_ptr(), dx.data_ptr(), m, n, k)
    quant_dx.launches += 1
    return dx.reshape(*lead, k)


quant_dx.launches = 0


def _check_int4(name, a, kq4, scale_g, a_dim):
    """a is x (its last dim K) or g (its last dim N); → (N, K, group)."""
    if a.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes a bf16 activation, got {a.dtype}")
    if kq4.dtype != torch.int8 or scale_g.dtype != torch.float32:
        raise TypeError(f"{name} takes int8 kq4 and f32 scales, got "
                        f"{kq4.dtype} and {scale_g.dtype}")
    nh, k = kq4.shape if kq4.dim() == 2 else (-1, -1)
    n = 2 * nh
    groups = scale_g.shape[0] if scale_g.dim() == 2 else 0
    group = k // groups if groups > 0 else 0
    _check(name, [
        (kq4.dim() == 2, f"kq4 must be (N/2, K), got {tuple(kq4.shape)}"),
        (a.shape[-1] == (k if a_dim == "K" else n),
         f"activation {tuple(a.shape)} does not match kq4 (N/2, K) = "
         f"{tuple(kq4.shape)}"),
        (scale_g.dim() == 2 and scale_g.shape[1] == n,
         f"scale_g {tuple(scale_g.shape)} is not (G, {n})"),
        (all(t.device == a.device for t in (kq4, scale_g)),
         f"operands on {a.device}, {kq4.device}, {scale_g.device}"),
        (all(t.is_contiguous() for t in (a, kq4, scale_g)),
         "activation, kq4 and scale_g must be contiguous"),
        (a.numel() > 0, "empty activation"),
        (a.data_ptr() % 16 == 0 and kq4.data_ptr() % 16 == 0,
         "activation and kq4 must be 16-byte aligned"),
        (n % 16 == 0 and group > 0 and group % GROUP == 0
         and k == group * groups,
         f"needs N % 16 == 0 and a group width that is a multiple of "
         f"{GROUP} and divides K, got N {n}, K {k}, G {groups}")])
    return n, k, group


def decode_splits(n: int, k: int, act_quant: bool) -> int:
    """Runs of 128-wide groups a 64-column tile of the decode route is cut
    into: 1 for w4a8 (its f32 fold takes the groups in order); for the
    weight-only branch as many as bring the tiles times the runs to
    DECODE_FILL blocks, at most one a group."""
    if act_quant:
        return 1
    tiles = -(-(n // 2) // 32)
    return max(1, min(k // GROUP, DECODE_FILL // tiles))


def int4_matmul(x, kq4, scale_g, act_quant: bool):
    """K8, the packed-int4 forward: x (..., K), kq4 (N/2, K) packed,
    scale_g (G, N) f32 → (..., N) in x.dtype; act_quant=True is w4a8, False
    the weight-only int4. x of at most DECODE_MAX_M rows takes the decode
    route at group 128."""
    if x.device.type == "cpu":
        return int4_matmul_ref(x, kq4, scale_g, act_quant)
    _device_ok("int4_matmul", x)
    n, k, group = _check_int4("int4_matmul", x, kq4, scale_g, "K")
    lead, x2 = _lead(x)
    m = x2.shape[0]
    if act_quant:
        _check("int4_matmul", [_tma_aligned(scale_g)])
        xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
        xs = _row_scales(m, k // group, x.device)
    else:
        xq = xs = x2                  # unused by the weight-only branch
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        if takes_decode_route(m, group):
            if scale_g.data_ptr() % 16:    # the decode route's TMA needs it
                scale_g = scale_g.clone()
            splits = decode_splits(n, k, act_quant)
            part = (torch.empty((splits, m, n), dtype=torch.float32,
                                device=x.device) if splits > 1 else out)
            _launch("int4_decode", x2.data_ptr(), kq4.data_ptr(),
                    scale_g.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                    part.data_ptr(), out.data_ptr(), m, n, k, group,
                    int(act_quant), splits)
            int4_matmul.decode_launches += 1
        else:
            _launch("int4_fwd", x2.data_ptr(), kq4.data_ptr(),
                    scale_g.data_ptr(), xq.data_ptr(), xs.data_ptr(),
                    out.data_ptr(), m, n, k, group, int(act_quant))
            int4_matmul.launches += 1
    return out.reshape(*lead, n)


int4_matmul.launches = 0
int4_matmul.decode_launches = 0


def int4_dx(g, kq4, scale_g):
    """K9, the packed-int4 backward: g (..., N), kq4 (N/2, K) packed,
    scale_g (G, N) f32 → dx (..., K) in g.dtype."""
    if g.device.type == "cpu":
        return int4_dx_ref(g, kq4, scale_g)
    _device_ok("int4_dx", g)
    n, k, group = _check_int4("int4_dx", g, kq4, scale_g, "N")
    _check("int4_dx", [_tma_aligned(scale_g)])
    lead, g2 = _lead(g)
    m = g2.shape[0]
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=g.device)
    with torch.cuda.device(g.device):
        _launch("int4_dx", g2.data_ptr(), kq4.data_ptr(), scale_g.data_ptr(),
                dx.data_ptr(), m, n, k, group)
    int4_dx.launches += 1
    return dx.reshape(*lead, k)


int4_dx.launches = 0


def int8_dgrad(g, kq, scale, s_mod: int):
    """K10, the w8a8d backward: g (..., N), kq (N, K) int8, scale (N,) f32,
    the dither's row period s_mod (g's dim -2, as JAX's iota over it) → dx
    (..., K) in g.dtype."""
    if g.device.type == "cpu":
        return int8_dgrad_ref(g, kq, scale, s_mod)
    _device_ok("int8_dgrad", g)
    n, k = _check_common("int8_dgrad", g, kq, scale, "N",
                         lambda n, k: (n,))
    _check("int8_dgrad", [(n % 16 == 0 and s_mod > 0,
                           f"needs N % 16 == 0 and s_mod > 0, got N {n}, "
                           f"s_mod {s_mod}")])
    lead, g2 = _lead(g)
    m = g2.shape[0]
    gq = torch.empty((m, n), dtype=torch.int8, device=g.device)
    gsc = torch.empty((m,), dtype=torch.float32, device=g.device)
    dx = torch.empty((m, k), dtype=torch.bfloat16, device=g.device)
    with torch.cuda.device(g.device):
        _launch("int8_dgrad", g2.data_ptr(), kq.data_ptr(), scale.data_ptr(),
                gq.data_ptr(), gsc.data_ptr(), dx.data_ptr(), m, n, k, s_mod)
    int8_dgrad.launches += 1
    return dx.reshape(*lead, k)


int8_dgrad.launches = 0
