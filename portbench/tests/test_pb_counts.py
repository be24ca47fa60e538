"""The FLOP, byte and roofline functions against hand counts."""
import pytest

from pbcore import counts, readers

CFG = {"model": {"dim": 8, "n_layers": 2, "n_heads": 2, "vocab_size": 16},
       "intermediate_size": 12,
       "method": {"adapter_len": 1, "max_feats": 2, "visual_dim": 4},
       "precision": {"linear_forward": "int8", "linear_dx": "bf16",
                     "head": "bf16", "other": "bf16",
                     "linear_weight": "int4g128", "head_weight": "bf16"}}
T = {"batch_size": 1, "accum_iter": 1, "max_seq_len": 4, "vaq": False,
     "qav": False, "remat": True, "n_options": 2}
PEAKS = {"ops_per_s": {"bf16": 100.0, "int8": 200.0}, "bytes_per_s": 10.0}


def test_train_update_flops_by_hand():
    # linears: (4*8*8 + 3*8*12) * 2 flops a token a layer = 1088; 2 layers,
    # 4 tokens: 8704 forward (int8) and 8704 dx (bf16); the adapter row's
    # k and v: 2 layers * 2 * 2*1*8*8 = 512 each way
    f = counts.train_update_flops(CFG, T)
    assert f["int8"] == 8704 + 512
    # causal text attention 4*1*4*2*8 = 256, adapter 4*1*4*1*8 = 128 a
    # layer, times 2 layers and 3 (forward + backward); the head 2*2*3*8*16;
    # visual_proj 2*2*1*2*4*8
    assert f["bf16"] == 8704 + 512 + 3 * 2 * (256 + 128) + 1536 + 256


def test_product_bytes_and_least_time():
    p = counts.Product(m=2, n=3, k=128, precision="int8", weight="int4g128")
    assert p.ops == 2 * 2 * 3 * 128
    assert p.bytes == 2 * (2 * 128 + 2 * 3) + (0.5 + 4 / 128) * 3 * 128
    # 1536 ops at 200/s = 7.68 s, 728 bytes at 10/s = 72.8 s: bytes bound
    assert counts.product_least_seconds([p], PEAKS) == pytest.approx(
        p.bytes / 10.0)


def test_train_products_count_recompute():
    prods = counts.train_linear_products(CFG, T)
    fwd = [p for p in prods if p.precision == "int8"]
    assert all(p.count == 2 * 2 for p in fwd if p.m == 4)   # remat, layers
    head = [p for p in prods if p.weight == "bf16"]
    assert len(head) == 2 and all(p.m == 3 for p in head)


def test_readers():
    ctx = {"counters": {"units": 2, "flops": {"bf16": 300.0, "int8": 400.0},
                        "linear_least_s": 1.5},
           "peaks": PEAKS, "window_s": 10.0, "busy_s": 7.5,
           "class_s": {"other": 0.4, "gemm_bf16": 2.0, "int4_gemm": 1.0},
           "classes": [{"name": "gemm_bf16", "linear": True},
                       {"name": "int4_gemm", "linear": True}]}
    assert readers.mfu(ctx) == pytest.approx(100 * (3.0 + 2.0) / 10.0)
    assert readers.idle_share(ctx) == pytest.approx(25.0)
    assert readers.plain_ms_per_unit(ctx) == pytest.approx(200.0)
    assert readers.linear_roofline(ctx) == pytest.approx(50.0)
    empty = dict(ctx, counters={})
    assert readers.mfu(empty) is None and readers.linear_roofline(empty) is None
