"""flipped_tpu_torch layers and plain attention against the JAX package, f32.

Inputs are made by numpy from a seed and handed to both; every comparison
is at atol = rtol = 1e-5 (f32 arithmetic in both, in different orders).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flipped_tpu.model import attention as jatt
from flipped_tpu.model import layers as jlay
from flipped_tpu_torch.model import attention as tatt
from flipped_tpu_torch.model import layers as tlay

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rms_norm():
    rs = np.random.RandomState(0)
    x, w = _rand(rs, 3, 5, 16), rs.rand(16).astype(np.float32)
    _close(tlay.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
           jlay.rms_norm(jnp.array(x), jnp.array(w), 1e-6))


def test_precompute_and_apply_rope():
    rs = np.random.RandomState(1)
    x = _rand(rs, 2, 9, 4, 16)
    jc, js = jlay.precompute_rope(16, 9)
    tc, ts = tlay.precompute_rope(16, 9)
    _close(tc, jc)
    _close(ts, js)
    _close(tlay.apply_rope(torch.tensor(x), tc, ts),
           jlay.apply_rope(jnp.array(x), jc, js))


def test_rope_rotates_interleaved_pairs():
    """Position 1 rotates (x0, x1) by θ0 = 1 rad: the pair is (x0, x1), not
    (x0, x_{Dh/2}) as in the half-split convention."""
    x = torch.zeros(1, 2, 1, 4)
    x[0, 1, 0, 0] = 1.0
    c, s = tlay.precompute_rope(4, 2)
    out = tlay.apply_rope(x, c, s)[0, 1, 0]
    np.testing.assert_allclose(out.numpy(), [np.cos(1.0), np.sin(1.0), 0, 0],
                               atol=1e-6)


def test_apply_rope_at():
    rs = np.random.RandomState(2)
    x = _rand(rs, 2, 6, 4, 16)
    pos = np.array([[3, 4, 5, 3, 4, 5], [7, 8, 9, 7, 8, 9]])
    jc, js = jlay.precompute_rope(16, 12)
    tc, ts = tlay.precompute_rope(16, 12)
    tp = torch.tensor(pos)
    _close(tlay.apply_rope_at(torch.tensor(x), tc[tp], ts[tp]),
           jlay.apply_rope_at(jnp.array(x), jc[pos], js[pos]))


def test_swiglu_and_hidden_size():
    rs = np.random.RandomState(3)
    x = _rand(rs, 4, 16)
    w1, w3, w2 = _rand(rs, 16, 24), _rand(rs, 16, 24), _rand(rs, 24, 16)
    ours = tlay.swiglu(torch.tensor(x), torch.tensor(w1.T),
                       torch.tensor(w2.T), torch.tensor(w3.T))
    _close(ours, jlay.swiglu(jnp.array(x), jnp.array(w1), jnp.array(w2),
                             jnp.array(w3)))
    for dim, mult in ((64, 32), (4096, 256), (6656, 256)):
        assert tlay.ffn_hidden_size(dim, mult) == jlay.ffn_hidden_size(dim,
                                                                       mult)


@pytest.mark.parametrize("vs", [[4, 0], [-1, 2]])
def test_video_block_bias(vs):
    g2 = np.array([-1.5, 0.5, 2.0], np.float32)
    _close(tatt.video_block_bias(torch.tensor(vs), 12, 3, torch.tensor(g2)),
           jatt.video_block_bias(jnp.array(vs), 12, 3, jnp.array(g2)))


def test_adapter_prefix_attention():
    rs = np.random.RandomState(4)
    q, ak, av = _rand(rs, 2, 7, 4, 8), _rand(rs, 5, 4, 8), _rand(rs, 5, 4, 8)
    g1 = _rand(rs, 4)
    _close(tatt.adapter_prefix_attention(*map(torch.tensor, (q, ak, av, g1))),
           jatt.adapter_prefix_attention(*map(jnp.array, (q, ak, av, g1))))


@pytest.mark.parametrize("vs", [[4, 7], [-1, -1], [0, 5]])
def test_adapter_gated_attention(vs):
    rs = np.random.RandomState(5)
    b, s, h, dh, al = 2, 20, 4, 8, 5
    q, k, v = (_rand(rs, b, s, h, dh) for _ in range(3))
    ak, av = _rand(rs, al, h, dh), _rand(rs, al, h, dh)
    g1, g2 = _rand(rs, h), _rand(rs, h)
    args = (q, k, v, ak, av, g1, g2)
    ours = tatt.adapter_gated_attention(*map(torch.tensor, args),
                                        torch.tensor(vs), 3)
    ref = jatt.adapter_gated_attention(*map(jnp.array, args),
                                       jnp.array(vs, jnp.int32), 3)
    _close(ours, ref)


@pytest.mark.parametrize("vs", [[2, 0], [-1, 3]])
def test_chunk_extend_attention(vs):
    rs = np.random.RandomState(6)
    b, n_opt, chunk, s_max, h, dh, al = 2, 3, 4, 14, 4, 8, 5
    q, kc, vc = (_rand(rs, b, n_opt * chunk, h, dh) for _ in range(3))
    ck, cv = _rand(rs, b, s_max, h, dh), _rand(rs, b, s_max, h, dh)
    ak, av = _rand(rs, al, h, dh), _rand(rs, al, h, dh)
    g1, g2 = _rand(rs, h), _rand(rs, h)
    prefix = [7, 10]
    args = (q, kc, vc, ck, cv, ak, av, g1, g2)
    ours = tatt.chunk_extend_attention(
        *map(torch.tensor, args), torch.tensor(vs), torch.tensor(prefix),
        n_opt, 3)
    ref = jatt.chunk_extend_attention(
        *map(jnp.array, args), jnp.array(vs, jnp.int32),
        jnp.array(prefix, jnp.int32), n_opt, 3)
    _close(ours, ref)
