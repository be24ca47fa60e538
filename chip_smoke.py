#!/usr/bin/env python3
"""Drive flipped_tpu_torch on one CUDA card, end to end.

    python3 chip_smoke.py

Phases; any failure prints its traceback and exits 1 without a result line:
  1. device   torch and CUDA versions, the card's name and power limit;
              exits 1 when torch sees no CUDA device (there is no CPU path)
  2. build    compile flipped_tpu_torch/csrc/ with nvcc for sm_90a, one
              process per source, all started together
  3. K1       flash_text_fwd against its plain version in bf16 at the unit
              shape and the main-path shapes, and lse against float64
  4. K2       flash_text_bwd against its plain version in bf16 at the unit
              shapes, the training shape and S 650, within the bound stated
              at K2_CASES; dgate2 against a float64 sum
  5. grads    the autograd.Function (K1 forward, K2 backward) against
              autograd through the plain formulation, all seven grads, at
              the training shape
  6. timing   K1 and K2, kernel and plain version: device time by CUDA-graph
              replay between CUDA events, host time per eager call; the
              library yardstick `scaled_dot_product_attention` with the
              gate2 + causal bias as a float mask (forward for K1, forward
              and backward for K2); and each kernel's bound from its bytes
              and operations
  7. train    `flipped_tpu_torch.cli.train.main` at LLaMA-7B width (dim
              4096, 32 layers, random bf16 frozen weights from a seed),
              --vaq --qav, batch 8, S 128, one epoch over 64 synthetic
              NExT-QA items (8 updates) with remat, then its val eval: every
              loss finite, 64 K1 and 32 K2 launches per update over the
              epoch, frozen weights bitwise unchanged, no trainable moved by
              update 1 (lr 0) and every trainable moved by update 2; then
              the step without remat (the bench default) timed
  8. eval     the classification eval at 7B width through
              `flipped_tpu_torch.cli.evaluate.main`: 32 K1 launches per
              scored batch, every score finite; one batch through the cached
              and the dense eval steps, which must agree
Each main path (7, 8) runs with the launch counts set to 0 just before it
and read just after. The last lines of stdout are the nvidia-smi line, a
JSON line of the kernels and the contract line {"ok": true, "device": ...}.
"""
import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

TRAIN_B, TRAIN_S = 8, 128           # --batch_size 8 --max_seq_len 128
# video_start per stacked row of the training encode: VQA and VAQ rows start
# their video at a prompt position, QAV rows carry -1 (no gate2 block)
TRAIN_VS = (5, 1, 9, 0, 5, 3, 2, 5) * 2 + (-1,) * TRAIN_B
TRAIN_SHAPE = (3 * TRAIN_B, TRAIN_S, 32, 128)   # --vaq --qav: 24 sequences

K1_SOURCE = "flipped_tpu_torch/csrc/flash_text_fwd.cu"
K1_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:59"
# (B, S, H, Dh, video_start per example): the unit shape (two batches, so
# -1, 0 and 5 all occur next to another value), the training encode, the
# cached prefill of the eval (batch 8), the dense encode (8 examples x 5
# options), the TVQA length
K1_CASES = [
    (2, 37, 4, 128, (-1, 5)),
    (2, 37, 4, 128, (0, 5)),
    (*TRAIN_SHAPE, TRAIN_VS),
    (8, 128, 32, 128, (5, 1, -1, 0, 5, 3, 2, 5)),
    (40, 128, 32, 128, (5,) * 40),
    (1, 650, 32, 128, (4,)),
]
MAX_FEATS = 10
# Tolerance of K1 against its plain version. The kernel rounds the
# unnormalised P to bf16 and divides by the row sum at the end; the plain
# version, like the TPU kernel, rounds the normalised P. Each rounding moves
# a term by at most 2^-9 relative, so the two outputs differ by at most
# 2^-8 * (P @ |V|) before the final rounding to bf16, which adds at most one
# bf16 ulp (<= 2^-7 |out|). The bound allows twice the first term:
#   |kernel - plain| <= 2^-7 * ((P @ |V|) + |plain|) + 2^-14
K1_REL = 2.0 ** -7
K1_ABS_FLOOR = 2.0 ** -14     # for outputs within rounding of zero
LSE_ATOL = 1e-4               # f32 row sums of up to 650 terms vs float64

K2_SOURCE = "flipped_tpu_torch/csrc/flash_text_bwd.cu"
K2_REPLACES = "flipped_tpu/model/pallas/flash_attention.py:174"
# K1 timing shapes: the training encode, the cached eval prefill (batch 8)
# and the dense eval encode (8 examples x 5 options)
K1_SHAPES = {"train": TRAIN_SHAPE, "prefill": (8, 128, 32, 128),
             "dense": (40, 128, 32, 128)}
ADAPTER_LEN = 10
N_TRAIN_ITEMS = 64                  # 8 updates at batch 8; 16 val examples
# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, dense bf16
# tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
K2_CASES = [
    (2, 37, 4, 128, (-1, 5)),
    (2, 37, 4, 128, (0, 5)),
    (*TRAIN_SHAPE, TRAIN_VS),
    (1, 650, 32, 128, (4,)),
]
# Tolerance of K2 against its plain version, from where the two differ.
# Both take the same bf16 operands. The kernel reads P as exp(s - lse) with
# K1's f32 lse, and D = rowsum(dO*O) with K1's bf16 output O; the plain
# version recomputes P by softmax and O = bf16(P).V in f32. Per element, with
# A = |dO|.|V|^T and B = scale |Q|.|K|^T:
#   - P of either side is within eps_P = 2^-16 (B + max_row B) relative of
#     the exact P (f32 sums of Dh products, and the f32 lse);
#   - the two D differ by E_D = |dO.(O_K1 - O_f64)| + |dO.(O_plain - O_f64)|
#     + 2^-15 |dO|.|O|, taken in float64 from the actual outputs;
#   - so the two f32 dS differ by at most
#       dds = P (2 eps_P |dP - D| + E_D + 2^-15 A) + 2^-15 |dS|;
#   - rounding P or dS to bf16 flips by at most one ulp, 2^-7 relative, and
#     the final rounding of dq, dk, dv by at most 2^-7 of the value.
# The bounds double each rounding term:
#   |dv| <= 2^-6 (P^T |dO| + |dv|)
#   |dq| <= scale (2^-6 |dS| + 2 dds) |K| + 2^-6 |dq|
#   |dk| <= scale (2^-6 |dS|^T + 2 dds^T) |Q| + 2^-6 |dk|
# dgate2 is held against the float64 sum of what the kernel computes from
# the same inputs (K1's O in D): within 2 sum_block (P (eps_P |dP - D|
# + 2^-16 A + 2^-16 |dO|.|O|) + 2^-16 |dS|).
K2_ABS_FLOOR = 1e-6
# The seven attention grads (K1 + K2 through the autograd.Function) against
# autograd through the plain formulation in bf16: the two differ by the bf16
# rounding of P, dS and the text output (relative 2^-8 per term, of random
# sign), so the relative Frobenius error of each grad is of order 2^-8; the
# bound allows four times that.
GRAD_REL = 2.0 ** -6
SCORE_RTOL = 2e-2             # cached vs dense eval, both bf16


def phase(name):
    print(f"== {name}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def k1_inputs(torch, b, s, h, dh, vs, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, dh, device="cuda", generator=g)
               .to(torch.bfloat16) for _ in range(3))
    gate2 = torch.randn(h, device="cuda", generator=g)
    video_start = torch.tensor(vs, dtype=torch.int32, device="cuda")
    return q, k, v, gate2, video_start


def check_k1(torch, fa):
    from flipped_tpu_torch.model.attention import video_block_bias

    worst = 0.0
    for i, (b, s, h, dh, vs) in enumerate(K1_CASES):
        q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs, i)
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        torch.cuda.synchronize()
        ref, _ = fa.flash_text_attention_ref(q, k, v, gate2, video_start,
                                             MAX_FEATS)
        torch.cuda.synchronize()
        ref32 = ref.float()
        err = (out.float() - ref32).abs()
        scale, _ = fa.flash_text_attention_ref(q, k, v.abs(), gate2,
                                               video_start, MAX_FEATS)
        bound = K1_REL * (scale.float() + ref32.abs()) + K1_ABS_FLOOR
        ratio = float((err / bound).max())
        sc = torch.einsum("bshd,bthd->bhst", q.double(), k.double()) \
            / math.sqrt(dh)
        sc = sc + video_block_bias(video_start, s, MAX_FEATS, gate2.double())
        causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        lse64 = torch.logsumexp(sc.masked_fill(~causal, -math.inf), dim=-1)
        lse_err = float((lse.double() - lse64).abs().max())
        torch.cuda.synchronize()
        max_err = float(err.max())
        worst = max(worst, max_err)
        print(f"K1 {(b, s, h, dh)} vs={vs[:4]}: max|out-plain|={max_err:.6g} "
              f"(worst {ratio:.3f} of the bound), "
              f"max|lse-f64|={lse_err:.3g}", flush=True)
        if not torch.isfinite(out).all():
            raise AssertionError("K1 produced non-finite values")
        if ratio > 1.0:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{(b, s, h, dh)}")
        if lse_err > LSE_ATOL:
            raise AssertionError(f"K1 lse off by {lse_err} at {(b, s, h, dh)}")
    return worst


def k2_inputs(torch, b, s, h, dh, vs, seed):
    q, k, v, gate2, video_start = k1_inputs(torch, b, s, h, dh, vs, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    do = torch.randn(b, s, h, dh, device="cuda", generator=g).to(
        torch.bfloat16)
    return q, k, v, gate2, video_start, do


def k2_bounds(torch, fa, q, k, v, gate2, video_start, do, out, refs):
    """Float64 quantities of the K2 tolerance (see K2_CASES): the bounds of
    |kernel - plain| for dq, dk, dv given the plain grads `refs`, and the
    float64 dgate2 of the kernel's inputs with its bound."""
    from flipped_tpu_torch.model.attention import video_block_bias

    b, s, h, dh = q.shape
    scale = 1.0 / math.sqrt(dh)
    q64, k64, v64, do64, out64 = (x.double() for x in (q, k, v, do, out))
    sc = torch.einsum("bshd,bthd->bhst", q64, k64) * scale
    sc = sc + video_block_bias(video_start, s, MAX_FEATS, gate2.double())
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(sc.masked_fill(~causal, -math.inf), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, v64)
    # the plain version's O, by its own ops on the same device
    p_plain = torch.softmax(fa._masked_scores(q, k, gate2, video_start,
                                              MAX_FEATS), dim=-1)
    o_plain = torch.einsum("bhst,bthd->bshd", p_plain.to(q.dtype).float(),
                           v.float()).double()
    rowdot = lambda x, y: (x * y).sum(-1).transpose(1, 2)     # (B,H,S)
    d = rowdot(o, do64)[..., None]
    dp = torch.einsum("bshd,bthd->bhst", do64, v64)
    ds = p * (dp - d)
    a = torch.einsum("bshd,bthd->bhst", do64.abs(), v64.abs())
    bb = torch.einsum("bshd,bthd->bhst", q64.abs(), k64.abs()) * scale
    eps_p = 2.0 ** -16 * (bb + bb.masked_fill(~causal, 0).amax(-1, True))
    do_o = rowdot(do64.abs(), out64.abs())[..., None]
    e_d = (rowdot(do64, out64 - o).abs() + rowdot(do64, o_plain - o).abs()
           )[..., None] + 2.0 ** -15 * do_o
    dds = p * (2 * eps_p * (dp - d).abs() + e_d + 2.0 ** -15 * a) \
        + 2.0 ** -15 * ds.abs()
    w = 2.0 ** -6 * ds.abs() + 2 * dds
    dq_ref, dk_ref, dv_ref = (x.double().abs() for x in refs)
    bound_dq = scale * torch.einsum("bhst,bthd->bshd", w, k64.abs()) \
        + 2.0 ** -6 * dq_ref + K2_ABS_FLOOR
    bound_dk = scale * torch.einsum("bhst,bshd->bthd", w, q64.abs()) \
        + 2.0 ** -6 * dk_ref + K2_ABS_FLOOR
    bound_dv = 2.0 ** -6 * (torch.einsum("bhst,bshd->bthd", p, do64.abs())
                            + dv_ref) + K2_ABS_FLOOR
    block = video_block_bias(video_start, s, MAX_FEATS,
                             torch.ones(h, dtype=torch.float64,
                                        device="cuda")) > 0
    ds_k = p * (dp - rowdot(out64, do64)[..., None])
    eps_k = p * (eps_p * (dp - d).abs() + 2.0 ** -16 * (a + do_o)) \
        + 2.0 ** -16 * ds.abs()
    dg2 = torch.where(block, ds_k, 0).sum(dim=(0, 2, 3))
    bound_dg2 = 2 * torch.where(block, eps_k, 0).sum(dim=(0, 2, 3)) \
        + K2_ABS_FLOOR
    return (bound_dq, bound_dk, bound_dv), dg2, bound_dg2


def check_k2(torch, fa):
    worst = 0.0
    for i, (b, s, h, dh, vs) in enumerate(K2_CASES):
        q, k, v, gate2, video_start, do = k2_inputs(torch, b, s, h, dh, vs, i)
        out, lse = fa.flash_text_attention(q, k, v, gate2, video_start,
                                           MAX_FEATS)
        grads = fa.flash_text_attention_bwd(q, k, v, gate2, video_start,
                                            MAX_FEATS, do, out, lse)
        torch.cuda.synchronize()
        refs = fa.flash_text_attention_bwd_ref(q, k, v, gate2, video_start,
                                               MAX_FEATS, do)
        bounds, dg2_64, bound_dg2 = k2_bounds(torch, fa, q, k, v, gate2,
                                              video_start, do, out, refs[:3])
        msg = []
        for name, x, ref, bound in zip(("dq", "dk", "dv"), grads, refs,
                                       bounds):
            if not torch.isfinite(x).all():
                raise AssertionError(f"K2 {name} non-finite at {(b, s, h)}")
            err = (x.double() - ref.double()).abs()
            ratio = float((err / bound).max())
            worst = max(worst, float(err.max()))
            msg.append(f"{name} max|d|={float(err.max()):.4g} "
                       f"({ratio:.3f} of bound)")
            if ratio > 1.0:
                raise AssertionError(f"K2 {name} disagrees with its plain "
                                     f"version at {(b, s, h, dh)}: "
                                     f"{ratio:.3f} of the bound")
        g_err = (grads[3].double() - dg2_64).abs()
        g_ratio = float((g_err / bound_dg2).max())
        torch.cuda.synchronize()
        print(f"K2 {(b, s, h, dh)} vs={vs[:4]}: " + ", ".join(msg)
              + f", dgate2 max|d-f64|={float(g_err.max()):.4g} "
              f"({g_ratio:.3f} of bound)", flush=True)
        if g_ratio > 1.0:
            raise AssertionError(f"K2 dgate2 off the float64 sum at "
                                 f"{(b, s, h, dh)}: {g_ratio:.3f} of bound")
    return worst


def device_ms(torch, fn, n=20, reps=5):
    """Device time of one call: `n` calls captured in a CUDA graph, replayed
    `reps` times between CUDA events. Replay has no host work between the
    launches, so this is the kernels' time, not the Python wrapper's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def host_us(torch, fn, n=30):
    """Host time of one eager call (enqueue only), after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def check_grads(torch, fa):
    """All seven grads of the autograd.Function against autograd through
    the plain formulation, at the training shape; returns the worst
    relative Frobenius error."""
    from flipped_tpu_torch.model.attention import adapter_gated_attention

    b, s, h, dh = TRAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    mk = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    leaves = [mk(b, s, h, dh).to(torch.bfloat16) for _ in range(3)] \
        + [mk(ADAPTER_LEN, h, dh).to(torch.bfloat16) for _ in range(2)] \
        + [mk(h) * 0.5, mk(h) - 3.0]          # gate1, gate2 (f32)
    w = mk(b, s, h * dh).to(torch.bfloat16)
    vs = torch.tensor(TRAIN_VS, dtype=torch.int32, device="cuda")
    grads = {}
    for name, fn in (("kernels", fa.flash_adapter_attention),
                     ("plain", adapter_gated_attention)):
        xs = [x.detach().requires_grad_() for x in leaves]
        out = fn(*xs, vs, MAX_FEATS)
        grads[name] = torch.autograd.grad(out, xs, w)
    torch.cuda.synchronize()
    worst, msg = 0.0, []
    for name, a, r in zip(("dq", "dk", "dv", "dak", "dav", "dgate1",
                           "dgate2"), grads["kernels"], grads["plain"]):
        if not torch.isfinite(a).all():
            raise AssertionError(f"{name} through the kernels is not finite")
        rel = float((a.double() - r.double()).norm() / r.double().norm())
        worst = max(worst, rel)
        msg.append(f"{name} {rel:.3g}")
        if rel > GRAD_REL:
            raise AssertionError(f"{name}: relative error {rel} > {GRAD_REL}")
    print(f"attention grads {TRAIN_SHAPE}, relative Frobenius error of "
          f"kernels vs plain autograd: " + ", ".join(msg), flush=True)
    return worst


def bound_ms(nbytes: float, flops: float):
    """(least time in ms, what bounds it) at the card's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def k1_bound(b, s, h, dh):
    """q, k, v read and out written (bf16), lse written (f32); QK^T and PV
    over the causal pairs."""
    nbytes = 4 * b * s * h * dh * 2 + b * h * s * 4
    return bound_ms(nbytes, 2 * 2 * dh * causal_pairs(s) * b * h)


def k2_bound(b, s, h, dh):
    """q, k, v, dout and lse read, dq, dk, dv written; five products
    (QK^T, dO V^T, P^T dO, dS K, dS^T Q) over the causal pairs. The kernel
    also reads out (for rowsum(dO*O)), but the function does not need it:
    O can be recomputed from the K and V it reads."""
    nbytes = 7 * b * s * h * dh * 2 + b * h * s * 4
    return bound_ms(nbytes, 5 * 2 * dh * causal_pairs(s) * b * h)


def sdpa_mask(torch, gate2, video_start, s):
    """The gate2 video block and the causal mask as one additive bf16 mask
    (B, H, S, S), the form `scaled_dot_product_attention` takes."""
    from flipped_tpu_torch.model.attention import video_block_bias

    bias = video_block_bias(video_start, s, MAX_FEATS, gate2.float())
    causal = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
    return bias.masked_fill(~causal, -math.inf).to(torch.bfloat16)


def timed(torch, kern, plain):
    """Host us per eager call of kernel and plain version, then their device
    ms in turns (plain, kernel, kernel, plain). The host times come first:
    after the CUDA graphs of `device_ms` the allocator's pools differ."""
    host = {"host_us": host_us(torch, kern),
            "plain_host_us": host_us(torch, plain)}
    p1, k1, k2, p2 = (device_ms(torch, f) for f in (plain, kern, kern, plain))
    return {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "runs": (k1, k2, p1, p2), **host}


def time_k1(torch, fa):
    import torch.nn.functional as F

    times = {}
    for name, (b, s, h, dh) in K1_SHAPES.items():
        q, k, v, gate2, vs = k1_inputs(torch, b, s, h, dh,
                                       (TRAIN_VS * 2)[:b], 100)
        t = timed(torch, lambda: fa.flash_text_attention(q, k, v, gate2, vs,
                                                         MAX_FEATS),
                  lambda: fa.flash_text_attention_ref(q, k, v, gate2, vs,
                                                      MAX_FEATS))
        mask = sdpa_mask(torch, gate2, vs, s)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t["library_ms"] = device_ms(
            torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          attn_mask=mask))
        t["bound_ms"], t["bound_by"] = k1_bound(b, s, h, dh)
        times[name] = t
        print(f"K1 timing {name} {(b, s, h, dh)}: device kernel "
              f"{t['ms']:.5f} ms, plain {t['plain_ms']:.5f} ms, sdpa "
              f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); runs {t['runs']}; host per eager call: "
              f"kernel {t['host_us']:.1f} us, plain "
              f"{t['plain_host_us']:.1f} us", flush=True)
    return times


def time_k2(torch, fa):
    import torch.nn.functional as F

    b, s, h, dh = TRAIN_SHAPE
    q, k, v, gate2, vs, do = k2_inputs(torch, b, s, h, dh, TRAIN_VS, 200)
    out, lse = fa.flash_text_attention(q, k, v, gate2, vs, MAX_FEATS)
    t = timed(torch, lambda: fa.flash_text_attention_bwd(
                  q, k, v, gate2, vs, MAX_FEATS, do, out, lse),
              lambda: fa.flash_text_attention_bwd_ref(
                  q, k, v, gate2, vs, MAX_FEATS, do))
    mask = sdpa_mask(torch, gate2, vs, s)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    dot = do.transpose(1, 2)

    def library():
        o = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in xs),
                                           attn_mask=mask)
        return torch.autograd.grad(o, xs, dot)

    t["library_ms"] = device_ms(torch, library)
    t["bound_ms"], t["bound_by"] = k2_bound(b, s, h, dh)
    print(f"K2 timing {TRAIN_SHAPE}: device kernel {t['ms']:.5f} ms, plain "
          f"{t['plain_ms']:.5f} ms, sdpa forward+backward "
          f"{t['library_ms']:.5f} ms, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']}); runs {t['runs']}; host per eager call: kernel "
          f"{t['host_us']:.1f} us, plain {t['plain_host_us']:.1f} us",
          flush=True)
    return t


def write_fixtures(root):
    import numpy as np

    from flipped_tpu_torch.data.synthetic import make_nextqa

    make_nextqa(root, N_TRAIN_ITEMS, np.random.RandomState(0))


def cli_args(data_root, *extra):
    from flipped_tpu_torch.core.config import get_args_parser

    return get_args_parser().parse_args(
        ["--model", "llama7B", "--dataset", "nextqa", "--data_root",
         data_root, "--max_seq_len", str(TRAIN_S), "--batch_size",
         str(TRAIN_B), "--device", "cuda", "--llama_model_path",
         os.path.join(WORK, "no_checkpoint"), *extra])


def run_train_slice(torch, fa, data_root):
    """The train CLI with its build, step and val entry points wrapped to
    watch them: snapshots of the parameters, every update's metrics, and
    the launch counts when the val eval starts."""
    from flipped_tpu_torch.cli import train as train_cli

    watch = {"metrics": [], "snaps": []}
    orig = (train_cli.build_train_state, train_cli.make_train_step,
            train_cli.val_one_epoch)

    def build(*a, **kw):
        model, cfg, tok = orig[0](*a, **kw)
        watch["model"] = model
        watch["frozen0"] = {n: p.detach().clone()
                            for n, p in model.named_parameters()
                            if not p.requires_grad}
        watch["snaps"].append(trainables(model))
        return model, cfg, tok

    def make_step(*a, **kw):
        step = orig[1](*a, **kw)

        def watched(batch):
            m = step(batch)
            watch["metrics"].append([float(x) for x in m])
            if len(watch["snaps"]) < 3:
                watch["snaps"].append(trainables(watch["model"]))
            return m
        return watched

    def val(*a, **kw):
        watch["at_val"] = (fa.flash_text_attention.launches,
                           fa.flash_text_attention_bwd.launches)
        return orig[2](*a, **kw)

    args = cli_args(data_root, "--vaq", "--qav", "--epochs", "1",
                    "--output_dir", "")
    train_cli.build_train_state, train_cli.make_train_step, \
        train_cli.val_one_epoch = build, make_step, val
    try:
        torch.cuda.reset_peak_memory_stats()
        fa.flash_text_attention.launches = 0
        fa.flash_text_attention_bwd.launches = 0
        t0 = time.perf_counter()
        model, history = train_cli.main(args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"k1": fa.flash_text_attention.launches,
                    "k2": fa.flash_text_attention_bwd.launches}
    finally:
        train_cli.build_train_state, train_cli.make_train_step, \
            train_cli.val_one_epoch = orig
    steps = len(watch["metrics"])
    k1_train, k2_train = watch["at_val"]
    print(f"train: main took {seconds:.3f} s (7B init and val eval "
          f"included), {steps} updates, launches over the epoch K1 "
          f"{k1_train}, K2 {k2_train}; over the whole run K1 "
          f"{launches['k1']}, K2 {launches['k2']}; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB", flush=True)
    for i, m in enumerate(watch["metrics"]):
        print(f"  update {i + 1}: loss {m[0]:.6f} (vqa {m[1]:.6f}, vaq "
              f"{m[2]:.6f}, qav {m[3]:.6f}), grad_norm {m[4]:.6g}, lr "
              f"{m[5]:.6g}", flush=True)
    print(f"  history: {json.dumps(history)}", flush=True)
    if steps != N_TRAIN_ITEMS // TRAIN_B:
        raise AssertionError(f"expected {N_TRAIN_ITEMS // TRAIN_B} updates, "
                             f"ran {steps}")
    if not all(math.isfinite(x) for m in watch["metrics"] for x in m):
        raise AssertionError("a training metric is not finite")
    blocks = len(model.layers)      # 32 at 7B: K1 runs twice with remat
    if (k1_train, k2_train) != (2 * blocks * steps, blocks * steps):
        raise AssertionError(f"launches over the epoch K1 {k1_train}, K2 "
                             f"{k2_train}: want {2 * blocks} and {blocks} "
                             f"per update")
    if launches["k2"] != k2_train or launches["k1"] <= k1_train:
        raise AssertionError("the val eval should launch K1 and not K2")
    for n, p in model.named_parameters():
        if not p.requires_grad and not torch.equal(p, watch["frozen0"][n]):
            raise AssertionError(f"frozen weight {n} changed")
    init, after1, after2 = watch["snaps"]
    moved1 = [n for n in init if not torch.equal(init[n], after1[n])]
    still2 = [n for n in init if torch.equal(after1[n], after2[n])]
    if moved1 or still2:
        raise AssertionError(f"update 1 (lr 0) moved {moved1}; update 2 "
                             f"left {still2} unchanged")
    print(f"  frozen weights bitwise unchanged; update 1 moved none of the "
          f"{len(init)} trainables, update 2 moved all of them", flush=True)
    del watch
    return model, args, launches


def trainables(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if p.requires_grad}


def time_train_step(torch, model, args, n=5):
    """One update without remat (the bench default) on one training batch:
    s per step (median of n after two warm-up updates), examples per
    second, peak allocated memory."""
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.pipeline import load_data
    from flipped_tpu_torch.text import load_tokenizer
    from flipped_tpu_torch.train.optim import make_optimizer
    from flipped_tpu_torch.train.step import make_train_step

    run_cfg = run_config_from_args(args)
    loader = load_data(run_cfg.data,
                       load_tokenizer("", n_words=model.cfg.vocab_size),
                       "train")
    it = iter(loader)
    batch = batch_to_device(next(it), "cuda")
    it.close()
    model.remat = False
    step = make_train_step(model, make_optimizer(model, run_cfg.train, 8,
                                                 TRAIN_B),
                           vaq=True, qav=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for i in range(n + 2):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        if i >= 2:
            secs.append(time.perf_counter() - t0)
        if not math.isfinite(float(m.loss)):
            raise AssertionError("non-finite loss in the timed updates")
    med = sorted(secs)[len(secs) // 2]
    peak = torch.cuda.max_memory_allocated()
    print(f"train step without remat: {med:.5f} s/step (median of {n}: "
          f"{', '.join(f'{x:.5f}' for x in secs)}), {TRAIN_B / med:.3f} "
          f"examples/s, peak allocated {peak / 2**30:.3f} GiB", flush=True)
    return med, peak


def run_eval_slice(torch, fa, data_root):
    from flipped_tpu_torch.cli import evaluate

    args = cli_args(data_root)
    torch.cuda.reset_peak_memory_stats()
    fa.flash_text_attention.launches = 0
    fa.flash_text_attention_bwd.launches = 0
    t0 = time.perf_counter()
    stats = evaluate.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.flash_text_attention.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"eval: evaluate.main took {seconds:.3f} s (7B init included), "
          f"{stats['batches']} batches, K1 launches {launches}, K2 launches "
          f"{fa.flash_text_attention_bwd.launches}, peak allocated "
          f"{peak / 2**30:.3f} GiB", flush=True)
    if stats["batches"] != 2:
        raise AssertionError(f"expected 2 val batches, got {stats['batches']}")
    if launches != 32 * stats["batches"]:
        raise AssertionError(f"K1 launched {launches} times for "
                             f"{stats['batches']} batches (want 32 each)")
    return args


def compare_cached_dense(torch, args):
    from flipped_tpu_torch.cli.evaluate import batch_to_device
    from flipped_tpu_torch.core.config import run_config_from_args
    from flipped_tpu_torch.data.datasets import build_dataset
    from flipped_tpu_torch.data.pipeline import Loader
    from flipped_tpu_torch.train.builder import build_eval_state
    from flipped_tpu_torch.train.step import make_eval_step

    run_cfg = run_config_from_args(args)
    model, _, tokenizer = build_eval_state(run_cfg, torch.device("cuda"))
    loader = Loader(build_dataset(run_cfg.data, tokenizer, "val"), 8,
                    shuffle=False, split="val", prefetch=0)
    it = iter(loader)
    batch = next(it)
    it.close()
    tb = batch_to_device(batch, "cuda")
    span = (int(batch["span_need"]), bool(batch["span_exact"]))
    steps = {"cached": make_eval_step(model, cached=True),
             "dense": make_eval_step(model, cached=False)}
    outs, secs = {}, {}
    for name, step in steps.items():
        outs[name] = step(tb, span_info=span)          # warm-up
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs[name] = step(tb, span_info=span)
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        secs[name] = sorted(runs)[1]
    c, d = outs["cached"]["scores"].float(), outs["dense"]["scores"].float()
    if not (torch.isfinite(c).all() and torch.isfinite(d).all()):
        raise AssertionError("non-finite eval scores")
    delta = (c - d).abs()
    agree = float((outs["cached"]["prediction"]
                   == outs["dense"]["prediction"]).float().mean())
    n = tb["vqa_tokens"].shape[0]
    print(f"cached vs dense on one batch: max|dscore|={float(delta.max()):.5g} "
          f"(|score| up to {float(d.abs().max()):.4g}), argmin agreement "
          f"{agree:.3f}", flush=True)
    for name in steps:
        print(f"eval {name}: {secs[name]:.5f} s/batch (median of 3), "
              f"{n / secs[name]:.2f} ex/s at batch {n}", flush=True)
    if bool((delta > SCORE_RTOL * d.abs()).any()):
        raise AssertionError("cached and dense scores disagree beyond "
                             f"{SCORE_RTOL} relative")


def main() -> int:
    import torch

    phase("device")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("torch sees no CUDA device: chip_smoke.py runs only on the card",
              file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, ROOT)
    from flipped_tpu_torch.model.kernels import build as kbuild
    from flipped_tpu_torch.model.kernels import flash_attention as fa

    phase("build")
    t0 = time.perf_counter()
    lib = kbuild.build(force=True)
    print(f"built {lib.path} in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip(), flush=True)

    phase("K1 vs plain")
    k1_err = check_k1(torch, fa)

    phase("K2 vs plain")
    k2_err = check_k2(torch, fa)

    phase("attention grads")
    check_grads(torch, fa)

    phase("timing")
    k1_times = time_k1(torch, fa)
    k2_time = time_k2(torch, fa)

    data_root = os.path.join(WORK, "data")
    write_fixtures(data_root)

    phase("train")
    model, args, train_launches = run_train_slice(torch, fa, data_root)
    time_train_step(torch, model, args)
    del model
    torch.cuda.empty_cache()

    phase("eval")
    compare_cached_dense(torch, run_eval_slice(torch, fa, data_root))

    if any(m in ("jax", "flipped_tpu") or m.startswith(("jax.", "flipped_tpu."))
           for m in sys.modules):
        raise AssertionError("the port pulled in jax or the JAX package")
    rows = []
    for name, source, replaces, launches, err, t in (
            ("flash_text_fwd", K1_SOURCE, K1_REPLACES, train_launches["k1"],
             k1_err, k1_times["train"]),
            ("flash_text_bwd", K2_SOURCE, K2_REPLACES, train_launches["k2"],
             k2_err, k2_time)):
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": err, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
