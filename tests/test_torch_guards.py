"""Guards on the port's package rules.

* No module of ``repro_torch`` (nor ``chip_smoke.py``) imports ``jax`` or
  anything of ``repro``: checked by importing each module on its own and
  by an AST scan of the sources.
* Entry points default to ``device="cuda"`` and raise without a card.
* Every serve knob whose path is not ported raises ``NotImplementedError``
  naming its ROADMAP item; the ported knobs build and generate
  (``tests/test_torch_engine.py`` and ``tests/test_torch_serve_knobs.py``
  hold them against the reference engine).
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import Model
from repro_torch.serve import ServeConfig, ServeEngine

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py"))
MODULES = sorted(
    ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in SOURCES)

# Each module is imported in a child forked from an interpreter that has
# imported only numpy and torch, so each child sees what importing that
# one module pulls in.
_PROBE = r"""
import importlib, json, os, sys
import numpy, torch
out = {}
for name in sys.argv[1:]:
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(name)
            msg = sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        except BaseException as e:
            msg = ["import failed: %r" % (e,)]
        os.write(w, json.dumps(msg).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        out[name] = json.loads(f.read())
    os.waitpid(pid, 0)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def import_probe():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES], capture_output=True,
        text=True, timeout=300,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_no_jax_and_no_repro(import_probe, module):
    assert import_probe[module] == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_has_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
        text=True, timeout=300, cwd=str(REPO),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _small():
    return reduced(get_config("gemma-7b"))


def test_model_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(_small())


def test_engine_default_device_raises_without_cuda(no_cuda):
    model = Model(_small(), device="cpu")
    params = model.init(0)
    cfg = ServeConfig(max_seq=32, batch_slots=2, kv_layout="paged")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(model, params, cfg)


def test_engine_rejects_a_model_bound_to_another_device(monkeypatch):
    model = Model(_small(), device="cpu")
    params = model.init(0)
    monkeypatch.setattr(model, "device", torch.device("cuda"))
    cfg = ServeConfig(max_seq=32, batch_slots=2, kv_layout="paged")
    with pytest.raises(ValueError, match="engine runs on cpu"):
        ServeEngine(model, params, cfg, device="cpu")


def test_launcher_default_device_raises_without_cuda(no_cuda):
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "gemma-7b", "--requests", "1"])


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main

    assert main(["--arch", "gemma-7b", "--requests", "2", "--max-new", "3",
                 "--device", "cpu"]) == 0
    assert "continuous/paged/fifo on cpu" in capsys.readouterr().out


def test_cotune_entry_points_default_to_the_card(no_cuda):
    """The live co-tuning entry points take a device whose default is the
    card (the reference's have no such argument)."""
    import inspect

    from repro_torch.core.sut_torch import TrainStepSUT
    from repro_torch.serve.space import LiveServeSUT, make_live_cotune_sut

    for fn in (TrainStepSUT, LiveServeSUT, make_live_cotune_sut):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_live_cotune_sut(_small())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TrainStepSUT(_small())
    model = Model(_small(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LiveServeSUT(model, model.init(0))


@pytest.mark.parametrize("knob", [
    dict(kv_layout="dense"),
    dict(runtime="wave"),
    dict(mesh_shape=(1, 2)),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_unported_knob_raises(knob):
    model = Model(_small(), device="cpu")
    base = dict(max_seq=32, batch_slots=2, kv_layout="paged")
    base.update(knob)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ServeEngine(model, model.init(0), ServeConfig(**base), device="cpu")


@pytest.mark.parametrize("knob", [
    dict(temperature=0.7),
    dict(schedule="sjf"),
    dict(schedule="interleave"),
    dict(page_policy="on_demand"),
    dict(share_prefix=True),
    dict(draft_len=2),
    dict(retune=True, retune_min_requests=1, retune_check_every=1),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_ported_knob_builds_and_generates(knob):
    """The knobs the live co-tuner sweeps build an engine on the CPU,
    generate every token asked for, and leave the pool balanced (their
    tokens and counts are held to the reference in
    ``tests/test_torch_serve_knobs.py``)."""
    model = Model(_small(), device="cpu")
    base = dict(max_seq=32, batch_slots=2, kv_layout="paged",
                prefill_chunk=4)
    base.update(knob)
    eng = ServeEngine(model, model.init(0), ServeConfig(**base),
                      device="cpu")
    res = eng.generate([[1, 2, 3, 4, 5], [1, 2, 3, 4, 6], [7, 8]], 4)
    assert [len(t) for t in res.tokens] == [4, 4, 4]
    assert eng.last_alloc.groups_in_use == 0
    eng.last_alloc.check_balanced()


@pytest.mark.parametrize("change", [
    dict(superblock=("swa",)), dict(superblock=("mlstm",)),
    dict(tie_embeddings=False)], ids=str)
def test_unported_model_config_raises(change):
    import dataclasses

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(dataclasses.replace(_small(), **change), device="cpu")
