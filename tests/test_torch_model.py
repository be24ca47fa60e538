"""flipped_tpu_torch model and checkpoint conversion against the JAX package.

A JAX FlippedVQAModel (f32 compute and storage, einsum attention) is
initialised from a seed, its gates set non-zero so both attention segments
count, and its tree converted with `params_from_flax` into the port model.
Both models then see the same numpy inputs; outputs agree at 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flipped_tpu.ckpt import convert as jconvert
from flipped_tpu.core.config import ModelConfig as JModelConfig
from flipped_tpu.model import FlippedVQAModel as JModel
from flipped_tpu_torch.ckpt import convert as tconvert
from flipped_tpu_torch.core.config import ModelConfig
from flipped_tpu_torch.model import FlippedVQAModel
from flipped_tpu_torch.train import (TRAINABLE_MARKERS, check_dtype_policy,
                                     init_params, is_trainable)

TOL = dict(rtol=1e-5, atol=1e-5)
B, S, F = 2, 20, 3
CFGS = {
    "all_layers": dict(dim=32, n_layers=2, n_heads=4, vocab_size=97,
                       multiple_of=16, max_seq_len=S, adapter_len=4,
                       adapter_layer=2, max_feats=F, visual_dim=16),
    "last_layers": dict(dim=32, n_layers=3, n_heads=4, vocab_size=97,
                        multiple_of=16, max_seq_len=S, adapter_len=4,
                        adapter_layer=2, max_feats=F, visual_dim=16),
}


def _jax_params(kw, seed=7):
    cfg = JModelConfig(**kw)
    model = JModel(cfg, dtype=jnp.float32, frozen_dtype=jnp.float32,
                   trainable_dtype=jnp.float32, use_flash=False)
    rs = np.random.RandomState(seed)
    tokens = jnp.array(rs.randint(0, cfg.vocab_size, (1, S)), jnp.int32)
    video = jnp.array(rs.randn(1, F, cfg.visual_dim), jnp.float32)
    vs = jnp.zeros((1,), jnp.int32)
    splice = jnp.arange(F, dtype=jnp.int32)[None]
    params = jax.device_get(jax.jit(model.init)(
        jax.random.PRNGKey(seed), tokens, video, None, vs, splice)["params"])
    for name, sub in params.items():
        if name.startswith("layers_"):
            h = cfg.n_heads
            sub["attention"]["gate1"] = 0.3 * (1.0 + np.arange(h, dtype=np.float32))
            sub["attention"]["gate2"] = -1.5 + 0.2 * np.arange(h, dtype=np.float32)
    return model, params


@pytest.fixture(scope="module", params=sorted(CFGS))
def pair(request):
    kw = CFGS[request.param]
    jmodel, params = _jax_params(kw)
    tmodel = FlippedVQAModel(ModelConfig(**kw), dtype=torch.float32,
                             frozen_dtype=torch.float32,
                             trainable_dtype=torch.float32)
    tmodel.load_state_dict(tconvert.params_from_flax(params), strict=True)
    rs = np.random.RandomState(11)
    data = dict(tokens=rs.randint(0, kw["vocab_size"], (B, S)).astype(np.int32),
                video=rs.randn(B, F, kw["visual_dim"]).astype(np.float32),
                vs=np.array([5, -1], np.int32),
                splice=np.array([[5, 6, 7], [9, 10, 11]], np.int32),
                prefix=np.array([13, 15], np.int32))
    return jmodel, {"params": params}, tmodel, data


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _t(data, *keys):
    return [torch.tensor(data[k]) for k in keys]


def _j(data, *keys):
    return [jnp.array(data[k]) for k in keys]


def test_params_from_flax_covers_every_leaf(pair):
    jmodel, params, tmodel, _ = pair
    flat = tconvert.flatten_flax(params["params"])
    sd = tconvert.params_from_flax(params["params"])
    assert len(sd) == len(flat)
    assert set(sd) == set(tmodel.state_dict())
    for path, leaf in flat.items():
        name = tconvert.flax_path_to_torch_name(path)
        shape = np.shape(leaf)
        if tconvert.needs_transpose(path):
            shape = shape[::-1]
        assert tuple(sd[name].shape) == shape, name
        if not is_trainable(name):
            # frozen leaves: the JAX converter's own name mapping
            assert jconvert.torch_name_to_flax_path(name) == path
            assert jconvert.needs_transpose(name) == \
                tconvert.needs_transpose(path)
    assert {"adapter_query.weight", "temporal_emb.weight",
            "visual_proj.weight"} <= set(sd)
    n_active = jmodel.cfg.adapter_layer
    layer_ids = {int(n.split(".")[1]) for n in sd if n.startswith("layers.")}
    assert layer_ids == set(range(jmodel.cfg.n_layers - n_active,
                                  jmodel.cfg.n_layers))


def test_fuse_and_encode(pair):
    jmodel, params, tmodel, d = pair
    vf = jmodel.apply(params, jnp.array(d["video"]), None, method="fuse")
    h = jmodel.apply(params, jnp.array(d["tokens"]), vf,
                     *_j(d, "vs", "splice"), method="encode")
    with torch.no_grad():
        tvf = tmodel.fuse(torch.tensor(d["video"]))
        th = tmodel.encode(torch.tensor(d["tokens"]), tvf,
                           *_t(d, "vs", "splice"))
    _close(tvf, vf)
    _close(th, h)


def test_lm_and_qav_logits(pair):
    jmodel, params, tmodel, d = pair
    lm, qav = jmodel.apply(params, jnp.array(d["tokens"]),
                           jnp.array(d["video"]), None, *_j(d, "vs", "splice"))
    with torch.no_grad():
        tlm, tqav = tmodel(torch.tensor(d["tokens"]), torch.tensor(d["video"]),
                           None, *_t(d, "vs", "splice"))
    _close(tlm, lm)
    _close(tqav, qav)


def test_prefill_and_extend_logits(pair):
    jmodel, params, tmodel, d = pair
    cache_len = S + 4
    vf = jmodel.apply(params, jnp.array(d["video"]), None, method="fuse")
    h, ck, cv = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, cache_len, method="prefill"))(
        params, jnp.array(d["tokens"]), vf, *_j(d, "vs", "splice"))
    span = np.random.RandomState(3).randint(0, 97, (B, 3, 4)).astype(np.int32)
    logits = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, method="extend_logits"))(
        params, jnp.array(span), ck, cv, *_j(d, "prefix", "vs"))
    with torch.no_grad():
        tvf = tmodel.fuse(torch.tensor(d["video"]))
        th, tck, tcv = tmodel.prefill(torch.tensor(d["tokens"]), tvf,
                                      *_t(d, "vs", "splice"), cache_len)
        tlogits = tmodel.extend_logits(torch.tensor(span), tck, tcv,
                                       *_t(d, "prefix", "vs"))
    _close(th, h)
    _close(tck, ck)
    _close(tcv, cv)
    _close(tlogits, logits)


def test_init_params_follows_flax_initialisers():
    cfg = ModelConfig(**CFGS["last_layers"], bias=2.5)
    model = FlippedVQAModel(cfg)               # bf16 frozen, f32 trainables
    init_params(model, seed=1)
    check_dtype_policy(model, torch.bfloat16)
    sd = model.state_dict()
    assert torch.all(sd["layers.2.attention.gate1"] == 0)
    assert torch.all(sd["layers.2.attention.gate2"] == -2.5)
    assert torch.all(sd["norm.weight"] == 1)
    wq = sd["layers.1.attention.wq.weight"].float()
    assert wq.abs().max() <= 1 / np.sqrt(cfg.dim) and wq.std() > 0.1
    emb = sd["tok_embeddings.weight"].float()
    assert 0.9 < emb.std() < 1.1
    init_params(model, seed=1)
    assert torch.equal(model.state_dict()["output.weight"], sd["output.weight"])
    assert all(is_trainable(n) for n in sd if n.endswith(("gate1", "gate2")))
    assert "gate" in TRAINABLE_MARKERS


@pytest.mark.parametrize("merge,shapes", [
    (None, {"visual_proj.weight": (32, 768)}),
    ("audio_only", {"audio_proj.weight": (32, 1024)}),
    ("sum", {"audio_proj.weight": (32, 1024),
             "visual_proj.weight": (32, 768)}),
    ("concat", {"visual_proj.weight": (32, 1792)}),
    ("attention", {"audio_proj.weight": (768, 1024),
                   "visual_proj.weight": (32, 768),
                   **{f"video_audio_cross_attn.{m}.{leaf}": shape
                      for m in ("query", "key", "value")
                      for leaf, shape in (("weight", (768, 768)),
                                          ("bias", (768,)))}})])
def test_model_builds_every_audio_merge(merge, shapes):
    """Each merge's fusion trainables, named and shaped as the reference
    state_dict's (JAX llama.py:545-563), f32 under the dtype policy; the
    cross-attention's biases start at zero, its kernels lecun-normal."""
    # the reference's widths: CLIP 768, ImageBind 1024
    cfg = ModelConfig(**{**CFGS["all_layers"], "visual_dim": 768},
                      audio_merge=merge)
    model = FlippedVQAModel(cfg)
    init_params(model, seed=0)
    check_dtype_policy(model, torch.bfloat16)
    fusion = {n: tuple(p.shape) for n, p in model.named_parameters()
              if "audio" in n or "visual_proj" in n}
    assert fusion == shapes
    sd = model.state_dict()
    for name in fusion:
        assert is_trainable(name) and sd[name].dtype == torch.float32, name
        if name.endswith("bias"):
            assert torch.all(sd[name] == 0), name
        elif name.startswith("video_audio_cross_attn"):
            std = 1 / np.sqrt(768)
            assert sd[name].abs().max() <= 2 * std / 0.8796 + 1e-6
            assert 0.8 * std < float(sd[name].std()) < 1.2 * std, name
