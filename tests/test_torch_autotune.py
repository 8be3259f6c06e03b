"""The port's autotune layer (``repro_torch.autotune``,
``repro_torch.analysis.feasibility``, the ops resolution and the tune
launcher), on the CPU with the Hopper cost model.

* Over the whole knob grid of every port ``KernelSpace``, at the
  Gemma-7B dims and at the CPU tests' dims: feasible ⇔ finite cost, and
  the default config is feasible; the gla space is the reference's
  (chunk choices, default, dims) and infeasible exactly where a head's
  state does not fit a block.
* The cache key format is the reference's; an entry either package
  writes to one file the other reads back; the backend component keeps
  the reference's ``cpu`` and ``tpu`` entries and the port's
  ``cuda-sm90`` and ``model-sm90`` (its cost model) apart.
* ``kernels.ops`` resolves explicit > tuned > default, and drops its memo
  when the cache is written.
* ``python -m repro_torch.launch.tune --tune-kernels --device cpu``
  persists the four kernels' entries under backend ``model-sm90`` and
  leaves the reference's ``cpu`` entries as they were.
"""
import dataclasses
import itertools
import json
import math

import pytest
import torch

from repro import autotune as jautotune
from repro_torch import autotune
from repro_torch.analysis.feasibility import kernel_feasibility
from repro_torch.autotune import KERNELS, AutotuneCache, KernelSpace
from repro_torch.kernels import ops

torch.set_num_threads(1)

# DK and DV are the GLA kernel's head dims (Zamba2's 64 at the model
# shapes; the largest the kernel takes at the serve shape); the other
# kernels ignore them
GEMMA = {"B": 1, "S": 4096, "SK": 4096, "H": 16, "KV": 16, "D": 256,
         "ROWS": 4096, "DK": 64, "DV": 64}
GEMMA_SERVE = {"B": 8, "S": 2048, "SK": 2048, "H": 16, "KV": 16, "D": 256,
               "ROWS": 8, "DK": 128, "DV": 128}
TEST_DIMS = {"B": 2, "S": 100, "SK": 100, "H": 4, "KV": 2, "D": 16,
             "ROWS": 5, "DK": 16, "DV": 8}


@pytest.fixture
def tmp_cache(tmp_path, monkeypatch):
    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    autotune.reset_default_cache()
    jautotune.reset_default_cache()
    yield path
    autotune.reset_default_cache()
    jautotune.reset_default_cache()


def _grid(kernel):
    space = KernelSpace(kernel).space()
    names = space.names
    for values in itertools.product(*(space[n].choices for n in names)):
        yield dict(zip(names, values))


@pytest.mark.parametrize("dims", [GEMMA, GEMMA_SERVE, TEST_DIMS],
                         ids=["gemma-train_4k", "gemma-serve", "test"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_feasible_iff_finite_cost(kernel, dtype, dims):
    d = KernelSpace(kernel).validate_dims(dims)
    model = kernel_feasibility(kernel, d, dtype)
    kdef = KERNELS[kernel]
    n_infeasible = 0
    for cfg in _grid(kernel):
        cost = kdef.model_cost(cfg, d, dtype)
        assert model(cfg) == math.isfinite(cost), (cfg, cost)
        assert cost > 0
        n_infeasible += not model(cfg)
    assert model(KernelSpace(kernel).space().default_config())
    if kernel == "flash_attention" and d["D"] == 256:
        assert n_infeasible > 0  # 128-row tiles at D=256 do not fit


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("kernel,dims", [
    ("flash_attention", {"B": 1, "S": 4096, "SK": 4096, "H": 16, "KV": 16,
                         "D": 256}),   # Gemma-7B train_4k
    ("flash_attention", {"B": 1, "S": 4096, "SK": 4096, "H": 32, "KV": 32,
                         "D": 64}),    # Zamba2-1.2B's shared block
    ("rmsnorm", {"ROWS": 4096, "D": 3072}),  # Gemma-7B d_model
    ("rmsnorm", {"ROWS": 4096, "D": 2048}),  # Zamba2-1.2B d_model
], ids=["flash-gemma", "flash-zamba2", "rmsnorm-gemma", "rmsnorm-zamba2"])
def test_redesigned_defaults_fit_both_dtypes(kernel, dims, dtype):
    """The default flash and RMSNorm configs launch at Gemma-7B's and
    Zamba2-1.2B's dims in both dtypes: feasible, at a finite cost."""
    default = ops.DEFAULT_BLOCKS[kernel]
    assert kernel_feasibility(kernel, dims, dtype)(default)
    assert math.isfinite(KERNELS[kernel].model_cost(default, dims, dtype))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_space_defaults_are_the_ops_defaults(kernel):
    space = KernelSpace(kernel).space()
    assert space.default_config() == ops.DEFAULT_BLOCKS[kernel]
    assert set(space.names) == set(KernelSpace(kernel).knobs)


def test_gla_space_matches_the_reference():
    """The gla space: the reference's chunk choices and default, its
    dims; no num_warps (the kernel's blocks are 128 threads by design)
    and no counterpart of the TPU's dim_semantics."""
    from repro.autotune.space import KERNELS as JKERNELS
    from repro.autotune.space import KernelSpace as JKernelSpace

    space, jspace = KernelSpace("gla").space(), JKernelSpace("gla").space()
    assert space["chunk"].choices == jspace["chunk"].choices
    assert space.default_config()["chunk"] == \
        jspace.default_config()["chunk"] == 128
    assert set(space.names) == {"chunk"}
    assert KERNELS["gla"].dims == JKERNELS["gla"].dims
    assert ops.DEFAULT_BLOCKS["gla"] == {"chunk": 128}


@pytest.mark.parametrize("dims", [
    {"B": 1, "S": 4096, "H": 64, "DK": 64, "DV": 64},    # Zamba2-1.2B
    {"B": 1, "S": 70, "H": 2, "DK": 128, "DV": 128},     # the largest head
    {"B": 1, "S": 256, "H": 2, "DK": 512, "DV": 513},    # xLSTM's mLSTM
], ids=["zamba2", "dk128", "xlstm"])
def test_gla_feasible_iff_the_state_fits(dims):
    """Feasible exactly where the cost is finite; a head whose f32 state
    overflows a block's shared memory is infeasible at every chunk."""
    model = kernel_feasibility("gla", dims, "float32")
    for cfg in _grid("gla"):
        cost = KERNELS["gla"].model_cost(cfg, dims, "float32")
        assert model(cfg) == math.isfinite(cost), (cfg, cost)
        assert model(cfg) == (dims["DK"] <= 128), cfg


def test_ops_gla_resolves_the_cache_but_the_model_passes_its_chunk(
        tmp_cache, monkeypatch):
    """``ops.gla`` resolves chunk explicit > tuned > default (an entry
    tuned while the space had a num_warps knob resolves its chunk);
    Mamba2 passes ``cfg.ssm_chunk`` explicitly (as the reference does),
    so a tuned chunk never reaches the model."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import ssm

    dims = {"B": 1, "S": 32, "H": 2, "DK": 8, "DV": 8}
    autotune.default_cache().put("gla", autotune.shape_sig(dims), "float32",
                                 "model-sm90", {"chunk": 16, "num_warps": 4},
                                 1.0)
    assert ops._resolve("gla", dims, torch.float32, "cpu",
                        {"chunk": None}) == {"chunk": 16}
    seen = []
    monkeypatch.setattr(ops, "gla_cuda",
                        lambda *a, **kw: seen.append(kw["chunk"]))
    q = torch.zeros(1, 32, 2, 8)
    ops.gla(q, q, q, torch.zeros(1, 32, 2))
    cfg = reduced(get_config("zamba2-1.2b"))
    ssm._gla(dataclasses.replace(cfg, gla_impl="pallas"), q, q, q,
             torch.zeros(1, 32, 2))
    assert seen == [16, cfg.ssm_chunk]


def test_key_format_is_the_reference_key():
    args = ("paged_attention", "B8_D256_H16_KV16_S2048", "bfloat16")
    for backend in ("cpu", "tpu", "cuda-sm90"):
        assert AutotuneCache.key(*args, backend) == \
            jautotune.AutotuneCache.key(*args, backend)
    assert AutotuneCache.key(*args, "cuda-sm90", "w1", "d1m2") == \
        jautotune.AutotuneCache.key(*args, "cuda-sm90", "w1", "d1m2")


def test_entries_cross_read_and_backends_stay_apart(tmp_cache):
    sig, dt = "B1_D256_H16_KV16_S4096", "bfloat16"
    jautotune.default_cache().put("decode_attention", sig, dt, "tpu",
                                  {"block_kv": 512}, 1.0)
    autotune.default_cache().put("decode_attention", sig, dt, "cuda-sm90",
                                 {"block_kv": 64, "num_warps": 8}, 2.0)
    jautotune.default_cache().put("decode_attention", sig, dt, "cpu",
                                  {"block_kv": 128}, 3.0)
    autotune.default_cache().put("decode_attention", sig, dt, "model-sm90",
                                 {"block_kv": 256, "num_warps": 0}, 4.0)
    fresh = AutotuneCache(tmp_cache)
    jfresh = jautotune.AutotuneCache(tmp_cache)
    for cache in (fresh, jfresh):
        assert cache.get_config("decode_attention", sig, dt, "tpu") == \
            {"block_kv": 512}
        assert cache.get_config("decode_attention", sig, dt,
                                "cuda-sm90") == {"block_kv": 64,
                                                 "num_warps": 8}
        assert cache.get_config("decode_attention", sig, dt, "cpu") == \
            {"block_kv": 128}
        assert cache.get_config("decode_attention", sig, dt,
                                "model-sm90") == {"block_kv": 256,
                                                  "num_warps": 0}
    assert len(json.load(open(tmp_cache))) == 4


def test_schema_migration_matches_reference(tmp_cache):
    raw = {"v2|rmsnorm|D64_ROWS8|float32|cpu": {"config": {"a": 1}},
           "v3|rmsnorm|D64_ROWS8|float32|cpu|-": {"config": {"a": 2}},
           "rmsnorm|D64_ROWS8|float32|cpu": {"config": {"a": 3}}}
    with open(tmp_cache, "w") as f:
        json.dump(raw, f)
    got = AutotuneCache(tmp_cache)
    want = jautotune.AutotuneCache(tmp_cache)
    assert got._load() == want._load()
    got.put("rmsnorm", "D8_ROWS1", "float32", "cpu", {"a": 4}, 0.0)
    assert set(json.load(open(tmp_cache))) == set(
        jautotune.AutotuneCache(tmp_cache)._load())


def test_backend_name():
    # the cost model's key, never the reference's "cpu"
    assert autotune.backend_name("cpu") == "model-sm90"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            autotune.backend_name()


def test_ops_resolve_explicit_over_tuned_over_default(tmp_cache):
    dims = {"B": 1, "S": 32, "SK": 32, "H": 2, "KV": 2, "D": 16}
    default = ops.DEFAULT_BLOCKS["flash_attention"]
    unset = {"block_q": None, "block_kv": None}
    assert ops._resolve("flash_attention", dims, torch.float32, "cpu",
                        unset) == default
    # an entry tuned before flash lost its num_warps knob keeps resolving
    # its tiles
    autotune.default_cache().put(
        "flash_attention", autotune.shape_sig(dims), "float32", "model-sm90",
        {"block_q": 16, "block_kv": 128, "num_warps": 8}, 1.0)
    # the write dropped the memo: the tuned entry now wins ...
    assert ops._resolve("flash_attention", dims, torch.float32, "cpu",
                        unset) == {"block_q": 16, "block_kv": 128}
    # ... knob by knob under an explicit argument
    assert ops._resolve("flash_attention", dims, torch.float32, "cpu",
                        dict(unset, block_q=32)) == {"block_q": 32,
                                                     "block_kv": 128}
    # another dtype or backend keys another entry
    assert ops._resolve("flash_attention", dims, torch.bfloat16, "cpu",
                        unset) == default


def test_ops_memoize_until_a_write(tmp_cache, monkeypatch):
    dims = {"ROWS": 8, "D": 64}
    calls = []
    real = autotune.resolve_blocks

    def counting(*a, **kw):
        calls.append(a[0])
        return real(*a, **kw)

    monkeypatch.setattr(autotune, "resolve_blocks", counting)
    x = torch.ones(8, 64)
    s = torch.ones(64)
    for _ in range(3):
        ops.rmsnorm(x, s)
    assert calls == ["rmsnorm"]
    autotune.default_cache().put("rmsnorm", autotune.shape_sig(dims),
                                 "float32", "model-sm90",
                                 {"block_rows": 8, "num_warps": 2}, 1.0)
    ops.rmsnorm(x, s)
    assert calls == ["rmsnorm", "rmsnorm"]


def test_autotune_kernel_on_the_cost_model(tmp_cache):
    res = autotune.autotune_kernel("decode_attention",
                                   {"B": 8, "S": 2048, "H": 16, "KV": 16,
                                    "D": 256}, dtype="bfloat16", budget=6,
                                   device="cpu")
    assert res["mode"] == "model" and res["backend"] == "model-sm90"
    assert res["n_tests"] == 6 and res["value"] <= res["default_value"]
    assert autotune.ensure_tuned(
        "decode_attention", {"B": 8, "S": 2048, "H": 16, "KV": 16,
                             "D": 256}, dtype="bfloat16",
        device="cpu") == res["config"]


def test_tune_launcher_persists_four_cpu_entries(tmp_cache, capsys):
    from repro_torch.launch.tune import main

    assert main(["--arch", "gemma-7b", "--shape", "train_4k",
                 "--tune-kernels", "--kernel-budget", "4",
                 "--device", "cpu"]) == 0
    keys = sorted(json.load(open(tmp_cache)))
    assert [k.split("|")[1] for k in keys] == [
        "decode_attention", "flash_attention", "paged_attention", "rmsnorm"]
    assert all(k.split("|")[4] == "model-sm90" for k in keys)
    assert "B1_D256_H16_KV16_S4096_SK4096" in keys[1]
    assert "D3072_ROWS4096" in keys[3]


def test_port_tune_leaves_the_reference_cpu_entries_byte_for_byte(
        tmp_cache):
    """A port cost-model tune into a file that holds the reference's
    ``cpu`` winners for the same (kernel, signature, dtype) writes its
    own ``model-sm90`` entries beside them and leaves each reference
    entry as it was, byte for byte."""
    from repro_torch.launch.tune import main

    sigs = {"flash_attention": "B1_D256_H16_KV16_S4096_SK4096",
            "rmsnorm": "D3072_ROWS4096"}
    jcache = jautotune.default_cache()
    jcache.put("flash_attention", sigs["flash_attention"], "bfloat16", "cpu",
               {"block_q": 128, "block_kv": 128}, 1.5)
    jcache.put("rmsnorm", sigs["rmsnorm"], "bfloat16", "cpu",
               {"block_rows": 8}, 2.5)

    def reference_entries():
        raw = json.load(open(tmp_cache))
        return {k: json.dumps(v, sort_keys=True) for k, v in raw.items()
                if k.split("|")[4] == "cpu"}

    before = reference_entries()
    assert len(before) == 2
    assert main(["--arch", "gemma-7b", "--shape", "train_4k",
                 "--tune-kernels", "--kernel-budget", "3",
                 "--device", "cpu"]) == 0
    assert reference_entries() == before
    keys = json.load(open(tmp_cache))
    assert sum(k.split("|")[4] == "model-sm90" for k in keys) == 4
    fresh = jautotune.AutotuneCache(tmp_cache)
    assert fresh.get_config("flash_attention", sigs["flash_attention"],
                            "bfloat16", "cpu") == {"block_q": 128,
                                                   "block_kv": 128}


@pytest.mark.parametrize("argv,match", [
    (["--joint", "--max-devices", "2"], "ROADMAP queue 1: multi-device"),
    (["--probe", "a=1"], "ROADMAP queue 1: dry-run and roofline"),
    ([], "ROADMAP queue 1: dry-run and roofline"),
])
def test_tune_launcher_unported_modes_raise(argv, match):
    from repro_torch.launch.tune import main

    with pytest.raises(NotImplementedError, match=match):
        main(["--arch", "gemma-7b", "--shape", "train_4k", *argv])
