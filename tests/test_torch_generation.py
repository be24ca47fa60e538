"""flipped_tpu_torch generation eval against the JAX package, on the CPU.

One f32 tree, initialised by the JAX model from a seed (gate1 and gate2
non-zero, so the adapter segment and the gate2 video block count), is
carried into the port (`params_from_flax`); both packages take the same
packed eval batch of `make_synthetic_items`. Held: `decode_attention`
(1e-6), the prefill cache and one `decode_step` (logits and caches, 1e-5),
`pool_option_embeddings` (1e-6), `gen_step` at the full 31 tokens
(tokens and predictions equal, similarities within 1e-5), the KV-cached
tokens against the port's own full re-forward (the reference's
algorithm), the decoded strings, `save_result`'s files, and one
`decode_step` at w8a8 through the plain K3.
"""
import json

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from flipped_tpu.ckpt import quantize as jquantize
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.core.config import quant_flags as jquant_flags
from flipped_tpu.data import make_synthetic_items, pack_eval_batch
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu.model.attention import decode_attention as jdecode_attention
from flipped_tpu.text import MockTokenizer as JMockTokenizer
from flipped_tpu.train import partition_params
from flipped_tpu.train.generation import \
    decode_generated as jdecode_generated
from flipped_tpu.train.generation import \
    make_generation_step as jmake_generation_step
from flipped_tpu.train.generation import \
    pool_option_embeddings as jpool_option_embeddings
from flipped_tpu.utils.logging import save_result as jsave_result
from flipped_tpu_torch.ckpt import params_from_flax
from flipped_tpu_torch.core.config import ModelConfig, model_quant_kwargs
from flipped_tpu_torch.model import FlippedVQAModel, decode_attention
from flipped_tpu_torch.model.kernels import quant_matmul as qm
from flipped_tpu_torch.text import MockTokenizer
from flipped_tpu_torch.train import (MAX_NEW_TOKENS, decode_generated,
                                     make_generation_step,
                                     pool_option_embeddings)
from flipped_tpu_torch.utils.logging import save_result

# tests/test_generation.py's config
KW = dict(dim=32, n_layers=2, n_heads=4, vocab_size=512, multiple_of=16,
          max_seq_len=96, adapter_len=4, adapter_layer=2, max_feats=4,
          visual_dim=16, bias=3.0)
N_NEW = 9          # the naive re-forward's horizon, as tests/test_generation.py
F32 = dict(dtype=jnp.float32, frozen_dtype=jnp.float32,
           trainable_dtype=jnp.float32, use_flash=False)
TF32 = dict(dtype=torch.float32, frozen_dtype=torch.float32,
            trainable_dtype=torch.float32)
HOST_KEYS = ("answer", "qtype", "gt_answer", "qid", "valid", "span_need",
             "span_exact")


def _gates(params, n_heads):
    heads = np.arange(n_heads, dtype=np.float32)
    for name, sub in params.items():
        if name.startswith("layers_"):
            sub["attention"]["gate1"] = 0.4 * np.ones(n_heads, np.float32)
            sub["attention"]["gate2"] = -2.0 + 0.9 * heads
    return params


def _batch(cfg, n, seed):
    items = make_synthetic_items(JMockTokenizer(cfg.vocab_size), n,
                                 max_feats=cfg.max_feats,
                                 max_seq_len=cfg.max_seq_len, split="val",
                                 visual_dim=cfg.visual_dim, seed=seed)
    batch = pack_eval_batch(items, cfg.max_feats)
    jb = {k: jnp.array(v) for k, v in batch.items() if k not in HOST_KEYS}
    tb = {k: torch.tensor(v) for k, v in batch.items() if k not in HOST_KEYS}
    return jb, tb


@pytest.fixture(scope="module")
def setup():
    cfg = JModelConfig(**KW)
    jb, tb = _batch(cfg, 3, 11)
    jmodel = JModel(cfg, **F32)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(1), jb["vqa_tokens"][:, 0], jb["video"], None,
        jb["vqa_video_start"], jb["vqa_splice"])["params"])
    params = _gates(params, cfg.n_heads)
    tmodel = FlippedVQAModel(ModelConfig(**KW), **TF32)
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, jb, tb


@pytest.fixture(scope="module")
def generated(setup):
    """Both packages' gen_step on the batch, at the full 31 tokens."""
    jmodel, params, tmodel, jb, tb = setup
    eos = JMockTokenizer(KW["vocab_size"]).eos_id
    trainable, frozen = partition_params(params)
    ref = jax.device_get(jmake_generation_step(jmodel, eos)(trainable,
                                                            frozen, jb))
    out = make_generation_step(tmodel, eos)(tb)
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in out.items()}


def test_decode_attention_matches_jax():
    """Random inputs; row 0 has no video (video_start -1), row 1 decodes at
    a position inside its video block (the gate2 block stays off), row 2
    past it (on)."""
    rs = np.random.RandomState(5)
    b, s_max, h, dh, al, mf = 3, 12, 4, 8, 4, 4
    a = dict(q=rs.randn(b, 1, h, dh), cache_k=rs.randn(b, s_max, h, dh),
             cache_v=rs.randn(b, s_max, h, dh), adapter_k=rs.randn(al, h, dh),
             adapter_v=rs.randn(al, h, dh), gate1=rs.randn(h),
             gate2=rs.randn(h))
    a = {k: v.astype(np.float32) for k, v in a.items()}
    vs = np.array([-1, 2, 1], np.int32)
    pos = np.array([7, 4, 11], np.int32)
    ref = np.asarray(jdecode_attention(
        *(jnp.asarray(v) for v in a.values()), jnp.asarray(vs),
        jnp.asarray(pos), mf))
    got = decode_attention(*(torch.from_numpy(v) for v in a.values()),
                           torch.from_numpy(vs), torch.from_numpy(pos), mf)
    assert got.shape == (b, 1, h * dh)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_prefill_and_decode_step_match_jax(setup):
    """The prefill's h and caches, then one decode step from JAX's caches:
    logits and the updated caches within 1e-5; the port writes the new K/V
    into the caches it was given and returns them."""
    jmodel, params, tmodel, jb, tb = setup
    p = {"params": params}
    s = jb["vqa_tokens"].shape[-1]
    cache_len = s + N_NEW + 1
    vf = jmodel.apply(p, jb["video"], None, method="fuse")
    h, ck, cv = jax.device_get(jmodel.apply(
        p, jb["vqa_tokens"][:, 0], vf, jb["vqa_video_start"],
        jb["vqa_splice"], cache_len, method="prefill"))
    with torch.inference_mode():
        th, tck, tcv = tmodel.prefill(tb["vqa_tokens"][:, 0],
                                      tmodel.fuse(tb["video"]),
                                      tb["vqa_video_start"],
                                      tb["vqa_splice"], cache_len)
    for got, want in ((th, h), (tck, ck), (tcv, cv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    pos = np.asarray(jb["prefix"])
    tok = np.asarray(jb["vqa_tokens"])[np.arange(3), 0, pos]
    logits, ck2, cv2 = jax.device_get(jmodel.apply(
        p, jnp.asarray(tok), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(pos), jb["vqa_video_start"], method="decode_step"))
    k_in, v_in = torch.tensor(np.asarray(ck)), torch.tensor(np.asarray(cv))
    with torch.inference_mode():
        tl, k_out, v_out = tmodel.decode_step(
            torch.tensor(tok), k_in, v_in, torch.tensor(pos),
            tb["vqa_video_start"])
    assert k_out is k_in and v_out is v_in
    for got, want in ((tl, logits), (k_out, ck2), (v_out, cv2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_pool_option_embeddings_match_jax(setup):
    jmodel, params, tmodel, jb, tb = setup
    eos = JMockTokenizer(KW["vocab_size"]).eos_id
    ref = np.asarray(jpool_option_embeddings(
        jmodel, {"params": params}, jb["vqa_tokens"], jb["prefix"], eos))
    with torch.no_grad():
        got = pool_option_embeddings(tmodel, tb["vqa_tokens"], tb["prefix"],
                                     eos)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_gen_step_matches_jax(generated):
    ref, out = generated
    assert out["generated"].shape == (3, MAX_NEW_TOKENS)
    np.testing.assert_array_equal(out["generated"], ref["generated"])
    np.testing.assert_allclose(out["similarity"], ref["similarity"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out["prediction"], ref["prediction"])


def _naive_greedy(tmodel, tb, n_new):
    """The reference's algorithm in the port: write each argmax token back
    into the sequence and re-run the full forward (model.py:429-467)."""
    tokens = tb["vqa_tokens"][:, 0].clone()
    prefix = tb["prefix"].numpy()
    out = np.zeros((tokens.shape[0], n_new), np.int64)
    with torch.no_grad():
        vf = tmodel.fuse(tb["video"])
        for b in range(tokens.shape[0]):
            toks = tokens[b:b + 1].clone()
            for i, pos in enumerate(range(prefix[b] - 1,
                                          prefix[b] - 1 + n_new)):
                h = tmodel.encode(toks, vf[b:b + 1],
                                  tb["vqa_video_start"][b:b + 1],
                                  tb["vqa_splice"][b:b + 1])
                pred = int(tmodel.lm_logits(h)[0, pos].argmax())
                out[b, i] = pred
                if pos + 1 < toks.shape[1]:
                    toks[0, pos + 1] = pred
    return out


def test_kv_cache_matches_full_reforward(setup):
    _, _, tmodel, _, tb = setup
    eos = MockTokenizer(KW["vocab_size"]).eos_id
    fast = make_generation_step(tmodel, eos, max_new_tokens=N_NEW)(tb)
    np.testing.assert_array_equal(fast["generated"].numpy(),
                                  _naive_greedy(tmodel, tb, N_NEW))


def test_decode_generated_strings_equal_jax(generated):
    ref, out = generated
    jtok, ttok = JMockTokenizer(KW["vocab_size"]), MockTokenizer(
        KW["vocab_size"])
    rows = list(out["generated"]) + [np.array([7, 9, ttok.eos_id, 5]),
                                     np.array([4, 0, 8])]
    for row in rows:
        assert decode_generated(ttok, row, ttok.eos_id) == \
            jdecode_generated(jtok, row, jtok.eos_id)


def test_save_result_files_equal_jax(tmp_path, generated):
    _, out = generated
    rows = [{"qid": 3 + i, "generated_answer": f"<{int(t)}>"}
            for i, t in enumerate(out["generated"][:, 0])]
    name = "extracted_answers_epoch0"
    ours = save_result(rows, str(tmp_path / "port"), name)
    ref = jsave_result(rows, str(tmp_path / "jax"), name)
    assert ours.endswith(f"port/{name}.json") and ref.endswith(
        f"jax/{name}.json")
    for fname in (f"{name}.json", f"{name}_rank0.json"):
        with open(tmp_path / "port" / fname) as a, \
                open(tmp_path / "jax" / fname) as b:
            text = a.read()
            assert text == b.read(), fname
            assert json.loads(text) == rows


def _jax_decode_with_linears(jmodel, p, *args):
    """JAX's decode_step → (logits, [(path, x)] for every Linear call in
    order), the inputs caught by flax's method interceptor."""
    paths = []

    def step(variables, *a):
        calls = []

        def catch(next_fun, args_, kw, ctx):
            if type(ctx.module).__name__ == "Linear" and \
                    ctx.method_name == "__call__":
                paths.append("/".join(ctx.module.path))
                calls.append(args_[0])
            return next_fun(*args_, **kw)
        with nn.intercept_methods(catch):
            return jmodel.apply(variables, *a, method="decode_step")[0], calls
    logits, calls = jax.jit(step)(p, *args)
    return np.asarray(logits), [(q, np.asarray(x))
                                for q, x in zip(paths, calls)]


def test_decode_step_w8a8_matches_jax():
    """w8a8 (K3's plain version in the port, JAX's XLA form): one decode
    step from the same caches, held as tests/test_torch_quant_model.py
    holds the w8a8 forward at f32: the logits within 1e-5 of the largest
    while every activation code agrees between the two; once one differs
    (a value within f32 rounding of a rounding tie: its inputs agree to
    1e-6 relative, at most 4 codes), every later layer sees another input
    and the logits are held to that test's 2.5e-3 of the largest. Tokens
    are not compared: a near-tie may move."""
    kw = dict(dim=256, n_layers=2, n_heads=2, vocab_size=97, multiple_of=128,
              max_seq_len=24, adapter_len=4, adapter_layer=2, max_feats=3,
              visual_dim=16)
    cfg = JModelConfig(**kw)
    rs = np.random.RandomState(13)
    b, s, cache_len = 2, 12, 16
    tokens = rs.randint(1, kw["vocab_size"], (b, s)).astype(np.int32)
    video = rs.randn(b, 3, kw["visual_dim"]).astype(np.float32)
    vs = np.array([2, -1], np.int32)
    splice = vs[:, None] + np.arange(3, dtype=np.int32)[None]
    fmodel = JModel(cfg, **F32)
    params = jax.device_get(jax.jit(fmodel.init)(
        jax.random.PRNGKey(7), jnp.asarray(tokens), jnp.asarray(video), None,
        jnp.asarray(vs), jnp.asarray(splice))["params"])
    params = _gates(params, cfg.n_heads)
    flags = jquant_flags("w8a8")
    qparams = jquantize.quantize_frozen(params, flags["quant_group"],
                                        flags["quant_outliers"])
    jmodel = JModel(cfg, **F32, **flags)
    tmodel = FlippedVQAModel(ModelConfig(**kw), **TF32,
                             **model_quant_kwargs("w8a8"))
    tmodel.load_state_dict(params_from_flax(qparams), strict=True)
    p = {"params": qparams}
    vf = jmodel.apply(p, jnp.asarray(video), None, method="fuse")
    _, ck, cv = jmodel.apply(p, jnp.asarray(tokens), vf, jnp.asarray(vs),
                             jnp.asarray(splice), cache_len,
                             method="prefill")
    tok, pos = tokens[:, -1], np.full(b, s, np.int32)
    logits, jcalls = _jax_decode_with_linears(
        jmodel, p, jnp.asarray(tok), ck, cv, jnp.asarray(pos),
        jnp.asarray(vs))
    tcalls = []
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: tcalls.append((name, i[0].numpy())))
        for name, mod in tmodel.named_modules()
        if type(mod).__name__ == "Linear" and mod.act_quant]
    with torch.inference_mode():
        got = tmodel.decode_step(
            torch.tensor(tok), torch.tensor(np.asarray(ck)),
            torch.tensor(np.asarray(cv)), torch.tensor(pos),
            torch.tensor(vs))[0].numpy()
    for h in hooks:
        h.remove()
    jcalls = [(q, x) for q, x in jcalls if not q.endswith("output")]
    assert len(tcalls) == len(jcalls)
    rel = 1e-5
    for (name, tx), (path, jx) in zip(tcalls, jcalls):
        assert path == name.replace("layers.", "layers_", 1).replace(".", "/")
        codes = [qm.quantize_act(torch.tensor(x).reshape(
            -1, x.shape[-1]))[0] for x in (tx, jx)]
        differ = int((codes[0] != codes[1]).sum())
        if differ:
            in_rel = np.abs(tx - jx).max() / np.abs(jx).max()
            assert differ <= 4 and in_rel <= 1e-6, (name, differ, in_rel)
            rel = 2.5e-3
            break
    assert np.abs(got - logits).max() <= rel * np.abs(logits).max()
