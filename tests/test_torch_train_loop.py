"""The port's fault-tolerant train loop (``repro_torch.train.loop``), its
launcher, ``models.count_params`` and ``TorchMeasuredSUT``.

* ``tests/test_train_serve.py::TestTrainLoop`` on the port: the loss
  decreases, microbatches and remat leave the losses, int8 compression
  trains, and a run killed by ``SimulatedFailure`` resumes from its
  newest checkpoint to the params of an uninterrupted run within the
  reference's tolerance (``rtol=1e-4, atol=1e-5``), with synchronous and
  with asynchronous saves.
* ``count_params`` equals the reference's for ``TINY`` and for the full
  and reduced ``gemma-7b`` and ``zamba2-1.2b`` (counted from shapes: no
  full-size tensor is made).
* ``TorchMeasuredSUT`` has ``JaxMeasuredSUT``'s space (the same configs
  from the same unit draws) and runs under the tuner on the CPU.
* ``launch.train`` and ``launch.serve --mixed --drift --retune`` run with
  ``--device cpu``; their default device is the card.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced as jax_reduced
from repro.core.sut_jax import JaxMeasuredSUT
from repro.models import count_params as jax_count_params
from repro_torch.configs import get_config, reduced
from repro_torch.core import Tuner
from repro_torch.core.sut_torch import TorchMeasuredSUT
from repro_torch.models import count_params
from repro_torch.optim import OptimizerConfig, tree_leaves
from repro_torch.train import (RunKnobs, SimulatedFailure, TrainLoopConfig,
                               train)
from test_torch_model import TINY, port_cfg

torch.set_num_threads(1)

CFG = port_cfg(TINY)
RESUME_TOL = dict(rtol=1e-4, atol=1e-5)


def _loop(**kw):
    base = dict(
        steps=12, seq_len=32, global_batch=4, log_every=0,
        opt=OptimizerConfig(learning_rate=3e-3, warmup_steps=2,
                            total_steps=50),
        knobs=RunKnobs(rules_preset="dp", remat="none", microbatches=1,
                       loss_chunk=0),
    )
    base.update(kw)
    return TrainLoopConfig(**base)


def _run(loop, **kw):
    return train(CFG, loop, device="cpu", **kw)


def _losses(out):
    return [h["loss"] for h in out["history"]]


class TestTrainLoop:
    def test_loss_decreases(self):
        out = _run(_loop(steps=25))
        assert np.mean(_losses(out)[-5:]) < np.mean(_losses(out)[:5])
        assert out["final_step"] == 25
        for h in out["history"]:
            assert h["step_seconds"] > 0
            assert h["tokens_per_sec"] == pytest.approx(
                32 * 4 / h["step_seconds"])

    def test_microbatch_equivalence(self):
        o1 = _run(_loop(steps=5))
        o2 = _run(_loop(steps=5, knobs=RunKnobs(
            rules_preset="dp", remat="none", microbatches=2, loss_chunk=0)))
        np.testing.assert_allclose(_losses(o1), _losses(o2), rtol=2e-3,
                                   atol=2e-3)

    def test_compression_trains(self):
        out = _run(_loop(steps=20, knobs=RunKnobs(
            rules_preset="dp", remat="none", microbatches=1, loss_chunk=0,
            compression="int8")))
        assert np.mean(_losses(out)[-5:]) < np.mean(_losses(out)[:5])

    def test_remat_equivalence(self):
        o1 = _run(_loop(steps=4))
        o2 = _run(_loop(steps=4, knobs=RunKnobs(
            rules_preset="dp", remat="full", microbatches=1, loss_chunk=0)))
        np.testing.assert_allclose(_losses(o1), _losses(o2), rtol=1e-4)

    @pytest.mark.parametrize("ckpt_async", [False, True],
                             ids=["sync", "async"])
    def test_crash_resume_matches_uninterrupted(self, tmp_path, ckpt_async):
        """Kill at step 6, resume from the step-5 checkpoint, finish: the
        final params equal an uninterrupted run's, and so do the losses
        of the resumed steps."""
        straight = _run(_loop(steps=10))
        ckpt = str(tmp_path / "ckpt")
        with pytest.raises(SimulatedFailure):
            _run(_loop(steps=10, ckpt_dir=ckpt, ckpt_every=5,
                       ckpt_async=ckpt_async, fail_at_step=6))
        assert sorted(os.listdir(ckpt)) == ["step_0000000005"]
        resumed = _run(_loop(steps=10, ckpt_dir=ckpt, ckpt_every=5,
                             ckpt_async=ckpt_async))
        assert resumed["final_step"] == 10
        assert len(resumed["history"]) == 5
        np.testing.assert_allclose(_losses(resumed), _losses(straight)[5:],
                                   **RESUME_TOL)
        for a, b in zip(tree_leaves(straight["params"]),
                        tree_leaves(resumed["params"])):
            np.testing.assert_allclose(b.float().numpy(),
                                       a.float().numpy(), **RESUME_TOL)
        assert int(resumed["opt_state"]["step"]) == 10
        assert sorted(os.listdir(ckpt)) == ["step_0000000005",
                                            "step_0000000010"]

    def test_final_save_off_the_period_and_retention(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        _run(_loop(steps=7, ckpt_dir=ckpt, ckpt_every=2, ckpt_keep=2))
        assert sorted(os.listdir(ckpt)) == ["step_0000000006",
                                            "step_0000000007"]

    def test_callbacks_see_every_step(self):
        seen = []
        _run(_loop(steps=3), callbacks=[lambda s, m: seen.append(
            (s, m["loss"]))])
        assert [s for s, _ in seen] == [0, 1, 2]


@pytest.mark.parametrize("name", ["tiny", "gemma-7b", "zamba2-1.2b"])
@pytest.mark.parametrize("cut", ["full", "reduced"])
def test_count_params_matches_reference(name, cut):
    if name == "tiny":
        want, cfg = jax_count_params(TINY), CFG
        if cut == "reduced":
            want, cfg = (jax_count_params(jax_reduced(TINY)),
                         reduced(CFG))
    else:
        jcfg, cfg = jax_get_config(name), get_config(name)
        if cut == "reduced":
            jcfg, cfg = jax_reduced(jcfg), reduced(cfg)
        want = jax_count_params(jcfg)
    assert count_params(cfg) == want
    if cut == "reduced":  # small enough to make: the count is the init's
        from repro_torch.models import Model

        params = Model(cfg, device="cpu").init(0)
        assert sum(p.numel() for p in tree_leaves(params)) == want


def test_count_params_gemma_width_two_layers():
    """The depth-cut Gemma-7B the card's train-loop phase runs."""
    cfg = dataclasses.replace(get_config("gemma-7b"), n_layers=2)
    assert count_params(cfg) == jax_count_params(dataclasses.replace(
        jax_get_config("gemma-7b"), n_layers=2)) == 1_340_095_488


def test_measured_sut_space_matches_reference():
    js = JaxMeasuredSUT(jax_reduced(jax_get_config("gemma-7b"))).space()
    ts = TorchMeasuredSUT(reduced(get_config("gemma-7b")),
                          device="cpu").space()
    assert ts.names == js.names
    assert ts.default_config() == js.default_config()
    u = np.random.default_rng(0).random((64, ts.dim))
    assert ts.from_unit_matrix(u) == js.from_unit_matrix(u)


def test_measured_sut_runs_under_the_tuner():
    sut = TorchMeasuredSUT(reduced(get_config("gemma-7b")), seq_len=32,
                           global_batch=4, steps=2, warmup=1, device="cpu")
    report = Tuner(sut.space(), sut, budget=3, seed=0).run()
    assert report.n_tests == 3
    for trial in report.history:  # the tuner minimizes -tokens/s
        assert np.isfinite(trial.value) and -trial.value > 0
    best = report.best_metric
    assert best.higher_is_better and best.value == -min(
        t.value for t in report.history)
    assert np.isfinite(best.metrics["loss"])


def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main

    ckpt = str(tmp_path / "ckpt")
    assert main(["--arch", "gemma-7b", "--steps", "4", "--seq-len", "32",
                 "--global-batch", "4", "--ckpt-dir", ckpt,
                 "--ckpt-every", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert re.search(r"gemma-7b-smoke on cpu: loss [\d.]+ -> [\d.]+ in 4 "
                     r"steps", out)
    assert sorted(os.listdir(ckpt)) == ["step_0000000002",
                                        "step_0000000004"]
    assert main(["--arch", "gemma-7b", "--steps", "4", "--seq-len", "32",
                 "--global-batch", "4", "--ckpt-dir", ckpt,
                 "--device", "cpu"]) == 0  # resumes at the last step
    assert "gemma-7b-smoke on cpu: already at step 4" in \
        capsys.readouterr().out
    # ... and saves nothing (the reference would save step 5)
    assert sorted(os.listdir(ckpt)) == ["step_0000000002",
                                        "step_0000000004"]


def test_serve_launcher_retunes_a_drifting_trace(tmp_path, monkeypatch,
                                                 capsys):
    from repro_torch import autotune
    from repro_torch.launch.serve import main

    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "c.json"))
    autotune.reset_default_cache()
    try:
        assert main(["--arch", "gemma-7b", "--requests", "24",
                     "--max-new", "16", "--mixed", "--drift", "--retune",
                     "--kv-layout", "paged", "--device", "cpu"]) == 0
    finally:
        autotune.reset_default_cache()
    out = capsys.readouterr().out
    assert re.search(r"retune @step \d+: drift [\d.]+ \[cold\] -> \S", out)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda):
    import inspect

    from repro_torch.launch.train import main

    for fn in (train, TorchMeasuredSUT):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train(CFG, _loop(steps=1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchMeasuredSUT(CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--arch", "gemma-7b", "--steps", "1"])
