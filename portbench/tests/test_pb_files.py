"""BENCHMARK.json, the configuration files and the registry: every part
of a cell is found by its name, from files alone."""
import json
import re

import pytest

from pbcore import registry

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    assert all(NAME.match(n) for n in names), names
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_published_sizes(entry):
    """DeepSeek LLM 7B base's published sizes, and the port's ModelConfig
    giving its intermediate size from them."""
    from pbcore import program
    cfg = registry.load_config(entry)
    assert entry["reduced"] == [] == cfg["reduced"]
    m = cfg["model"]
    assert (m["dim"], m["n_layers"], m["n_heads"], m["vocab_size"]) == (
        cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["num_attention_heads"], cfg["vocab_size"]) == (
        4096, 30, 32, 102400)
    assert cfg["num_key_value_heads"] == cfg["num_attention_heads"]
    assert m["norm_eps"] == cfg["rms_norm_eps"] == 1e-6
    assert m["rope_theta"] == cfg["rope_theta"] == 10000.0
    mc = program.model_config(cfg, bias=3.5, max_seq_len=128)
    assert mc.ffn_hidden == cfg["intermediate_size"] == 11008
    assert mc.adapter_layer == mc.n_layers == 30
    assert len(cfg["source"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_parts_found_by_name(cell):
    c = registry.Cell(BENCH, cell)
    mode = registry.load_mode(c.mode)
    for attr in ("Session", "reference", "compare"):
        assert hasattr(mode, attr)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(c.end_to_end) >= 3 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in {e["name"] for e in c.end_to_end}
        assert callable(registry.load_metric(m["name"]).read)
    spec = json.loads((registry.HERE / "workloads" / f"{cell}.json")
                      .read_text())
    assert set(spec["limits"]) == set(c.limits) and spec["control"]


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter alike."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"step", "generation", "model (plain layers)",
                      "kernels", "device"}


CLASSIFIED = [
    ("nvjet_tst_128x256_64x4_2x1_v_bz_coopA_TNT", "gemm_bf16"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemm_bf16"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", "gemm_f32"),
    ("void int8_fwd_quantize_kernel<4096>(...)", "int8_gemm"),
    ("quantize_rows_grouped_kernel", "int8_gemm"),
    ("int4_w4a8_wgmma_kernel<true>", "int4_gemm"),
    ("int4_decode_sum_kernel", "int4_gemm"),
    ("int4_dx_wgmma_kernel", "int4_dx"),
    ("flash_text_fwd_kernel<false>", "flash_text"),
    ("flash_bwd_dq_kernel", "flash_text"),
    ("flash_stream_dkv_kernel", "flash_stream"),
    ("wgmma_int8::kn_gemm_row_kernel", "int8_dgrad"),
    ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, "
     "float, float, float, float, false, true>", "gemv_f32"),
    ("void at::native::vectorized_elementwise_kernel<4, silu>", "other"),
    ("void at::native::reduce_kernel<512, 1>", "other"),
]


@pytest.mark.parametrize("name,cls", CLASSIFIED)
def test_kernel_classes(name, cls):
    assert registry.classify(name, registry.kernel_classes()) == cls
