"""The long-context path: K5, K6a and K6b (the streaming attention kernels)
through their plain versions against the JAX package, the regime switch of
the autograd.Function, the chunked LM head and remat groups.

The plain K5 and K6 are held against JAX's `flash_streaming_fwd` /
`flash_streaming_bwd` run in interpret mode with 128-row blocks (so S 256
is a 2 x 2 grid), at a ragged S and at q_offset shards against longer K/V.
The CUDA kernels run only on the card: tests/test_torch_kernels_gpu.py
(marked `gpu`) and chip_smoke.py hold them against these plain versions.
"""
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import jax
import jax.numpy as jnp
import optax  # noqa: F401  (the JAX train step below builds on it)

import flipped_tpu.model.pallas.flash_attention as jfa
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import TrainConfig as JTrainConfig
from flipped_tpu.data import add_accum_axis, make_synthetic_items, \
    pack_train_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.text import MockTokenizer
from flipped_tpu.train import make_optimizer as jmake_optimizer
from flipped_tpu.train import make_train_step as jmake_train_step
from flipped_tpu.train import partition_params
from flipped_tpu.train.objectives import \
    lm_ce_rowwise_chunked as jlm_ce_chunked
from flipped_tpu.train.optim import lr_schedule as jlr_schedule
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.ckpt.convert import flatten_flax, \
    flax_path_to_torch_name
from flipped_tpu_torch.core.config import ModelConfig, TrainConfig
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.model.kernels import flash_attention as fa
from flipped_tpu_torch.train import (compute_objective_losses,
                                     is_trainable, make_optimizer,
                                     make_train_step, trainable_parameters)
from flipped_tpu_torch.train.objectives import lm_ce_rowwise_chunked

MF = 10            # max_feats
BLOCK = 128        # the JAX streaming kernels' block in interpret mode


def _qkv(b, s_q, s_k, h, dh, seed):
    """bf16-exact inputs (numpy f32 rounded through bf16) so both packages
    start from the same values."""
    rs = np.random.RandomState(seed)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)
                              .astype(jnp.float32))
    q = bf(rs.randn(b, s_q, h, dh).astype(np.float32))
    k, v = (bf(rs.randn(b, s_k, h, dh).astype(np.float32)) for _ in range(2))
    g = bf(rs.randn(b, s_q, h, dh).astype(np.float32) * 0.5)
    return q, k, v, g, rs.randn(h).astype(np.float32)


def _j(x):
    return jnp.asarray(x, jnp.bfloat16)


def _t(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


# (B, S_q, S_k, q_offset): one 2 x 2 grid, a ragged S (padded and masked
# in the TPU kernel), two shards of S 256 and a ragged shard, both against
# longer K/V, the second shard above half of the keys (its first key tiles
# are causally live, its last ones are not)
STREAM_CASES = [(2, 256, 256, 0), (2, 200, 200, 0), (1, 128, 256, 0),
                (1, 128, 256, 128), (2, 72, 200, 100)]


def _k5_bound(q, k, v, g2, vs, q_offset, ref):
    """|plain − TPU kernel| for K5: the TPU kernel rounds the unnormalised
    P (exp(s − running max)) to bf16 and divides by the row sum at the end,
    the plain version rounds the normalised P. Each rounding moves a term by
    at most half an ulp, 2^-8 relative, so the two differ by at most
    2^-7 (P @ |V|) before their final roundings to bf16 (2^-8 |out| each);
    both sides' f32 sums of S_k terms and S_k/128 rescales, and their score
    errors (2^-17 B, B = scale |q|·|k|, moving each P by as much), add
    (2 (S_k + S_k/128) 2^-24 + 2^-16 max B) (P @ |V|); a floor covers
    outputs within rounding of zero (the bound chip_smoke.py holds K5 to,
    with the card's 64-key tiles)."""
    s_k, dh = k.shape[1], q.shape[3]
    mag, _ = fa.flash_streaming_fwd_ref(q, k, v.abs(), g2, vs, MF, q_offset)
    # max B over the rows and keys, bounded by the largest |q| and |k| of
    # each head dim
    max_b = float((q.float().abs().amax(1) * k.float().abs().amax(1))
                  .sum(-1).max()) / dh ** 0.5
    mag = mag.float()
    return (2.0 ** -7 * (mag + ref.float().abs()) + 2.0 ** -14
            + (2 * (s_k + s_k / 128) * 2.0 ** -24 + 2.0 ** -16 * max_b) * mag)


@pytest.mark.parametrize("b,s_q,s_k,q_offset", STREAM_CASES)
def test_plain_k5_matches_pallas_interpret(b, s_q, s_k, q_offset):
    q, k, v, _, g2 = _qkv(b, s_q, s_k, 2, 32, seed=s_q + q_offset)
    vs = np.array([3, -1][:b], np.int32)
    out_j, lse_j = jfa.flash_streaming_fwd(
        _j(q), _j(k), _j(v), jnp.asarray(g2), jnp.asarray(vs), MF,
        block=BLOCK, interpret=True, q_offset=jnp.int32(q_offset))
    args = (_t(q), _t(k), _t(v), torch.tensor(g2), torch.tensor(vs))
    out, lse = fa.flash_streaming_fwd(*args, MF, q_offset=q_offset)
    assert out.dtype == torch.bfloat16 and lse.shape == (b, 2, s_q)
    ref = np.asarray(out_j.astype(jnp.float32))
    bound = _k5_bound(*args, q_offset, out).numpy()
    assert (np.abs(out.float().numpy() - ref) <= bound).all()
    # both f32 sums of at most 256 exp terms and of 32 products, in other
    # orders: a few f32 ulp of values below 20
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j)[:, :, :s_q, 0],
                               rtol=0, atol=1e-5)


def _bf16_tol(ref):
    """One bf16 ulp of a flip in P or dS moves a grad by at most 2^-7 of
    one of its terms: 2^-6 relative, with an absolute floor of 2^-7 of the
    largest grad for elements that cancel to near zero (as K2's)."""
    return dict(rtol=2.0 ** -6, atol=2.0 ** -7 * float(np.abs(ref).max()))


@pytest.mark.parametrize("b,s_q,s_k,q_offset", STREAM_CASES)
def test_plain_k6_matches_pallas_interpret(b, s_q, s_k, q_offset):
    """Both packages read the same saved forward (JAX's out and lse) and
    round P and dS to bf16 before their products: only f32 summation orders
    differ, and a bf16 rounding that they move flips by one ulp."""
    q, k, v, g, g2 = _qkv(b, s_q, s_k, 2, 32, seed=10 + s_q + q_offset)
    vs = np.array([3, -1][:b], np.int32)
    jargs = (_j(q), _j(k), _j(v), jnp.asarray(g2), jnp.asarray(vs), MF)
    out_j, lse_j = jfa.flash_streaming_fwd(
        *jargs, block=BLOCK, interpret=True, q_offset=jnp.int32(q_offset))
    ref = jfa.flash_streaming_bwd(
        *jargs, _j(g), o_text=out_j, lse=lse_j, block=BLOCK, interpret=True,
        q_offset=jnp.int32(q_offset))
    o_text = torch.tensor(np.asarray(out_j.astype(jnp.float32))).to(
        torch.bfloat16)
    lse = torch.tensor(np.asarray(lse_j)[:, :, :s_q, 0])
    got = fa.flash_streaming_bwd(_t(q), _t(k), _t(v), torch.tensor(g2),
                                 torch.tensor(vs), MF, _t(g), o_text, lse,
                                 q_offset=q_offset)
    assert got[0].shape == (b, s_q, 2, 32) and got[1].shape == (b, s_k, 2, 32)
    for name, x, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert x.dtype == torch.bfloat16
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(x.float().numpy(), r, err_msg=name,
                                   **_bf16_tol(r))
    # dgate2 sums f32 dS on both sides: only the summation order differs
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-4, atol=1e-4)


def test_plain_k6_shards_sum_to_the_full_backward():
    """The sequence-parallel contract in the port's own plain versions, at
    f32 (no bf16 rounding): four q shards' dq are the full dq's row slices,
    their full-length dk, dv and dgate2 partials sum to the full result."""
    q, k, v, g, g2 = _qkv(2, 96, 96, 3, 16, seed=3)
    vs = torch.tensor([5, -1], dtype=torch.int32)
    q, k, v, g, g2 = map(torch.tensor, (q, k, v, g, g2))
    out, lse = fa.flash_streaming_fwd(q, k, v, g2, vs, MF)
    full = fa.flash_streaming_bwd(q, k, v, g2, vs, MF, g, out, lse)
    sums, dqs = [0.0, 0.0, 0.0], []
    for i in range(4):
        sl = slice(24 * i, 24 * (i + 1))
        o_i, lse_i = fa.flash_streaming_fwd(q[:, sl], k, v, g2, vs, MF,
                                            q_offset=24 * i)
        torch.testing.assert_close(o_i, out[:, sl], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse_i, lse[:, :, sl], rtol=1e-6,
                                   atol=1e-6)
        dq, dk, dv, dg2 = fa.flash_streaming_bwd(
            q[:, sl], k, v, g2, vs, MF, g[:, sl], o_i, lse_i,
            q_offset=24 * i)
        assert dk.shape == k.shape
        dqs.append(dq)
        sums = [a + x for a, x in zip(sums, (dk, dv, dg2))]
    torch.testing.assert_close(torch.cat(dqs, 1), full[0], rtol=1e-5,
                               atol=1e-5)
    for name, a, r in zip(("dk", "dv", "dgate2"), sums, full[1:]):
        torch.testing.assert_close(a, r, rtol=1e-5, atol=1e-5, msg=name)


def test_plain_per_head_equals_k1_k2_plain_on_all_heads():
    """The streaming plain versions go one head at a time (so that they fit
    on the card at S 8192); at q_offset 0 and S_k = S_q they compute what
    the plain K1 and K2 compute on all heads at once. f32 inputs, so the two
    differ only in the order of f32 sums: 1e-5."""
    q, k, v, g, g2 = map(torch.tensor, _qkv(2, 40, 40, 5, 16, seed=4))
    vs = torch.tensor([2, -1], dtype=torch.int32)
    out, lse = fa.flash_streaming_fwd_ref(q, k, v, g2, vs, MF)
    out1, lse1 = fa.flash_text_attention_ref(q, k, v, g2, vs, MF)
    torch.testing.assert_close(out, out1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, lse1, rtol=1e-5, atol=1e-5)
    bwd = fa.flash_streaming_bwd(q, k, v, g2, vs, MF, g, out, lse)
    bwd1 = fa.flash_text_attention_bwd_ref(q, k, v, g2, vs, MF, g)
    for name, a, b in zip(("dq", "dk", "dv", "dgate2"), bwd, bwd1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


# --- the regime switch of the autograd.Function ------------------------------

GRAD_NAMES = ("q", "k", "v", "ak", "av", "g1", "g2")


def _attn_case(seed, s):
    rs = np.random.RandomState(seed)
    b, h, dh, al = 2, 2, 16, 3
    arrs = dict(q=rs.randn(b, s, h, dh), k=rs.randn(b, s, h, dh),
                v=rs.randn(b, s, h, dh), ak=rs.randn(al, h, dh),
                av=rs.randn(al, h, dh), g1=rs.randn(h), g2=rs.randn(h))
    arrs = {n: x.astype(np.float32) for n, x in arrs.items()}
    return arrs, rs.randn(b, s, h * dh).astype(np.float32), \
        np.array([37, -1], np.int32)


def test_streaming_regime_matches_jax_custom_vjp_bf16(monkeypatch):
    """With MAX_SEQ_* set low on both sides, the seven grads of the port's
    Function (plain K5 forward, plain K6 backward from the saved text and
    lse) against jax.grad of the JAX custom VJP (its streaming kernels in
    interpret mode), both in bf16. S 200 is one 256-row block of the TPU
    kernels' default 512 (the multi-block grid is held above)."""
    for mod in (fa, jfa):
        monkeypatch.setattr(mod, "MAX_SEQ_FWD", 64)
        monkeypatch.setattr(mod, "MAX_SEQ_BWD", 64)
    monkeypatch.setattr(jfa, "INTERPRET", True)
    arrs, w, vs = _attn_case(31, 200)
    vsj = jnp.array(vs)

    def loss(q_, k_, v_, ak_, av_, g1_, g2_):
        out = jfa._flash_adapter_attention(q_, k_, v_, ak_, av_, g1_, g2_,
                                           vsj, 3)
        return jnp.sum(out.astype(jnp.float32) * jnp.array(w))

    args = [jnp.array(arrs[n], jnp.float32 if n in ("g1", "g2")
                      else jnp.bfloat16) for n in GRAD_NAMES]
    ref = jax.grad(loss, argnums=tuple(range(7)))(*args)
    leaves = [torch.tensor(arrs[n]).to(torch.float32 if n in ("g1", "g2")
                                       else torch.bfloat16).requires_grad_()
              for n in GRAD_NAMES]
    out = fa.flash_adapter_attention(*leaves, torch.tensor(vs), 3)
    (out.float() * torch.tensor(w)).sum().backward()
    for name, x, r in zip(GRAD_NAMES, leaves, ref):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(x.grad.float().numpy(), r, err_msg=name,
                                   **_bf16_tol(r))


WRAPPERS = ("flash_text_attention", "flash_text_attention_bwd",
            "flash_streaming_fwd", "flash_streaming_bwd")
KERNELS = ("flash_text_attention", "flash_text_attention_bwd",
           "flash_streaming_fwd", "flash_streaming_dq", "flash_streaming_dkv")


@pytest.fixture
def spies(monkeypatch):
    """Count the calls of each wrapper (the kernels' own calls to each
    other included, as the JAX dispatch makes them) and set MAX_SEQ_FWD 32,
    MAX_SEQ_BWD 16; "kernels" holds the unwrapped kernel wrappers, whose
    launch counts the spies leave alone."""
    calls = dict.fromkeys(WRAPPERS, 0)
    calls["kernels"] = {n: getattr(fa, n) for n in KERNELS}
    for name in WRAPPERS:
        def spy(*a, _name=name, _fn=getattr(fa, name), **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(fa, name, spy)
    monkeypatch.setattr(fa, "MAX_SEQ_FWD", 32)
    monkeypatch.setattr(fa, "MAX_SEQ_BWD", 16)
    return calls


def _run(s, grad: bool, remat: bool = False):
    arrs, w, vs = _attn_case(5, s)
    leaves = [torch.tensor(arrs[n]).requires_grad_(grad) for n in GRAD_NAMES]
    fn = lambda *xs: fa.flash_adapter_attention(*xs, torch.tensor(vs), 3)
    with torch.set_grad_enabled(grad):
        out = (checkpoint(fn, *leaves, use_reentrant=False) if remat
               else fn(*leaves))
        if grad:
            (out * torch.tensor(w)).sum().backward()


# (S, differentiated, remat) → calls of (K1 wrapper, K2 wrapper, K5, K6),
# as JAX chooses: a differentiated call above MAX_SEQ_BWD runs K5 and K6
# (the remat recompute takes K5 again); a forward-only call takes
# flash_text_attention, which hands S > MAX_SEQ_FWD to K5
DISPATCH = [((12, True, False), (1, 1, 0, 0)),
            ((24, True, False), (0, 0, 1, 1)),
            ((24, True, True), (0, 0, 2, 1)),
            ((40, True, True), (0, 0, 2, 1)),
            ((24, False, False), (1, 0, 0, 0)),
            ((40, False, False), (1, 0, 1, 0))]


@pytest.mark.parametrize("case,want", DISPATCH)
def test_regime_chosen_as_in_jax_and_cpu_launches_nothing(spies, case, want):
    kernels = spies["kernels"]
    before = {n: f.launches for n, f in kernels.items()}
    _run(*case)
    assert tuple(spies[n] for n in WRAPPERS) == want
    assert {n: f.launches for n, f in kernels.items()} == before


def test_k2_wrapper_hands_long_sequences_to_k6(spies):
    """`flash_text_attention_bwd` above MAX_SEQ_BWD is K6's call, reading
    the saved out and lse, as the JAX wrapper dispatches (:241-245)."""
    q, k, v, g, g2 = map(torch.tensor, _qkv(1, 20, 20, 2, 16, seed=8))
    vs = torch.tensor([2], dtype=torch.int32)
    out, lse = fa.flash_streaming_fwd_ref(q, k, v, g2, vs, MF)
    got = fa.flash_text_attention_bwd(q, k, v, g2, vs, MF, g, out, lse)
    assert spies["flash_streaming_bwd"] == 1
    ref = fa.flash_text_attention_bwd_ref(q, k, v, g2, vs, MF, g)
    for x, r in zip(got, ref):
        torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-5)


# --- the chunked LM head and remat groups against JAX ------------------------

KW = dict(dim=32, n_layers=3, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=3, max_feats=4,
          visual_dim=16)
TCFG = dict(epochs=8, warmup_epochs=1.0, lr=1e-2, weight_decay=0.1)
STEPS_PER_EPOCH, WORLD_BATCH = 4, 4
# as tests/test_torch_train.py: f32 on both sides, so losses agree to f32
# rounding and each trainable to 1e-3 of the lr (AdamW's scale-free step)
LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = JModelConfig(**KW)
    items = make_synthetic_items(MockTokenizer(cfg.vocab_size), 4,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len,
                                 visual_dim=cfg.visual_dim, seed=6)
    batch = pack_train_batch(items, cfg.max_feats)
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(2), jnp.array(batch["vqa_tokens"]),
        jnp.array(batch["video"]), None, jnp.array(batch["vqa_video_start"]),
        jnp.array(batch["vqa_splice"]))["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = np.full(4, 0.3, np.float32)
    return cfg, jmodel, params, batch


def _torch_model(params, remat=False, remat_group=1):
    model = FlippedVQAModel(ModelConfig(**KW), dtype=torch.float32,
                            frozen_dtype=torch.float32,
                            trainable_dtype=torch.float32, remat=remat,
                            remat_group=remat_group)
    model.load_state_dict(params_from_flax(params), strict=True)
    return model


@pytest.mark.parametrize("chunk", [16, 95, 200])
def test_lm_ce_rowwise_chunked_matches_jax(setup, chunk):
    """Chunk 16 does not divide S − 1 = 95 (a short last chunk; JAX pads
    it with ignored labels), 95 is one chunk, 200 is clamped to S − 1. The
    per-row CE sums and counts, and the gradient of Σ w·sum with respect to
    h (through the per-chunk recompute), at f32."""
    _, jmodel, params, _ = setup
    rs = np.random.RandomState(chunk)
    h = rs.randn(3, 95, KW["dim"]).astype(np.float32)
    labels = rs.randint(1, KW["vocab_size"], (3, 95)).astype(np.int32)
    labels[:, :30] = 0          # a prompt: ignored positions
    w = rs.randn(3).astype(np.float32)

    def jloss(h_):
        tot, cnt = jlm_ce_chunked(jmodel, {"params": params}, h_,
                                  jnp.array(labels), chunk)
        return jnp.sum(tot * jnp.array(w)), (tot, cnt)

    (_, (tot_j, cnt_j)), dh_j = jax.value_and_grad(jloss, has_aux=True)(
        jnp.array(h))
    model = _torch_model(params)
    ht = torch.tensor(h).requires_grad_()
    tot, cnt = lm_ce_rowwise_chunked(model, ht, torch.tensor(labels),
                                     chunk)
    (tot * torch.tensor(w)).sum().backward()
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(tot.detach().numpy(), np.asarray(tot_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(dh_j), rtol=1e-4,
                               atol=1e-6)


def test_lm_chunk_and_remat_group_give_the_dense_losses_and_grads(setup):
    """The chunked head changes only the order of the loss sums, and a
    remat group recomputes the same blocks: losses and trainable grads of
    (--lm_head_chunk 16, --remat_group 2) equal those of the dense head
    without remat to f32 rounding."""
    _, _, params, batch = setup
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    out = []
    for remat, group, chunk in ((False, 1, 0), (True, 2, 16)):
        model = _torch_model(params, remat=remat, remat_group=group)
        named = trainable_parameters(model)
        losses = compute_objective_losses(model, tb, vaq=True, qav=True,
                                          lm_chunk=chunk)
        losses.total.backward()
        out.append(([x.detach() for x in losses], [p.grad for _, p in named]))
    (l0, g0), (l1, g1) = out
    for a, b in zip(l0 + g0, l1 + g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_train_step_with_lm_chunk_and_remat_group_matches_jax(setup):
    """Three updates of the tiny preset's shape with --lm_head_chunk 16 and
    --remat_group 2 (three blocks: one group of two and one of one), JAX
    `make_train_step(lm_chunk=16)` + optax against the port's step."""
    cfg, _, params, batch = setup
    jmodel = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                    trainable_dtype=jnp.float32, use_flash=False, remat=True,
                    remat_group=2)
    tcfg = JTrainConfig(vaq=True, qav=True, **TCFG)
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH, WORLD_BATCH)
    step = jmake_train_step(jmodel, tx, vaq=True, qav=True,
                            lr_fn=jlr_schedule(tcfg, STEPS_PER_EPOCH,
                                               WORLD_BATCH), lm_chunk=16)
    trainable, frozen = partition_params(params)
    opt_state = tx.init(trainable)
    jb = {k: jnp.array(v) for k, v in add_accum_axis(batch, 1).items()}
    ref = []
    for _ in range(3):
        trainable, opt_state, m = step(trainable, opt_state, frozen, jb)
        ref.append([float(x) for x in m])

    model = _torch_model(params, remat=True, remat_group=2)
    frozen0 = {n: p.detach().clone() for n, p in model.named_parameters()
               if not is_trainable(n)}
    tstep = make_train_step(
        model, make_optimizer(model, TrainConfig(vaq=True, qav=True, **TCFG),
                              STEPS_PER_EPOCH, WORLD_BATCH),
        vaq=True, qav=True, lm_chunk=16)
    tb = {k: torch.tensor(v) for k, v in add_accum_axis(batch, 1).items()}
    ours = [[float(x) for x in tstep(tb)] for _ in range(3)]
    np.testing.assert_allclose(np.array(ours), np.array(ref), **LOSS_TOL)
    sd = model.state_dict()
    for path, leaf in flatten_flax(jax.device_get(trainable)).items():
        if leaf is None:
            continue
        name = flax_path_to_torch_name(path)
        got, want = sd[name].numpy(), np.asarray(leaf)
        np.testing.assert_allclose(got.T if got.shape != want.shape else got,
                                   want, err_msg=name, **PARAM_TOL)
    for n, p in model.named_parameters():
        if n in frozen0:
            assert torch.equal(p, frozen0[n]), n


# --- the CLIs on the long-context options ------------------------------------

@pytest.fixture(scope="module")
def long_root(tmp_path_factory):
    from flipped_tpu_torch.data.synthetic import make_nextqa

    root = tmp_path_factory.mktemp("torch_long_data")
    make_nextqa(str(root), 4, np.random.RandomState(0))
    return str(root)


def _cli_args(root, *extra):
    from flipped_tpu_torch.core.config import get_args_parser

    return get_args_parser().parse_args(
        ["--model", "tiny", "--dataset", "nextqa", "--data_root", root,
         "--batch_size", "1", "--device", "cpu", "--max_seq_len", "256",
         *extra])


def test_train_and_eval_clis_take_the_streaming_regime(long_root,
                                                       monkeypatch):
    """The train CLI with --lm_head_chunk and --remat_group, and the eval
    CLI, with MAX_SEQ_* below S: every block of every update runs K5 twice
    (the update's forward and the recompute) and K6 once, the val and eval
    prefills (S > MAX_SEQ_FWD) run K5; the losses are finite."""
    from flipped_tpu_torch.cli import evaluate, train

    monkeypatch.setattr(fa, "MAX_SEQ_FWD", 128)
    monkeypatch.setattr(fa, "MAX_SEQ_BWD", 128)
    calls = {"fwd": 0, "bwd": 0}
    for key, name in (("fwd", "flash_streaming_fwd"),
                      ("bwd", "flash_streaming_bwd")):
        def spy(*a, _key=key, _fn=getattr(fa, name), **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(fa, name, spy)
    model, history = train.main(_cli_args(
        long_root, "--vaq", "--qav", "--epochs", "1", "--output_dir", "",
        "--lm_head_chunk", "48", "--remat_group", "2"))
    stats = history[0]
    blocks = len(model.layers)
    assert model.remat and model.remat_group == 2
    assert stats["train_steps"] == 4 and stats["val_batches"] == 2
    assert all(np.isfinite(stats[f"train_{k}"]) and stats[f"train_{k}"] > 0
               for k in ("vqa_loss", "vaq_loss", "qav_loss", "grad_norm"))
    assert calls == {"fwd": (4 * 2 + 2) * blocks, "bwd": 4 * blocks}
    calls.update(fwd=0, bwd=0)
    out = evaluate.main(_cli_args(long_root))
    assert out["batches"] == 2 and calls == {"fwd": 2 * blocks, "bwd": 0}


def test_profile_classes_the_streaming_kernels():
    from flipped_tpu_torch.cli import profile

    for name in ("flash_stream_fwd_kernel<128>", "flash_stream_dq_kernel<128>",
                 "flash_stream_dkv_kernel<128>"):
        assert profile.kernel_class(
            f"void (anonymous namespace)::{name}(flash::FwdArgs)") \
            == "flash stream (K5/K6)"
