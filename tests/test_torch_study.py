"""The port's accuracy study (``feddat_tpu_torch/study.py``) against the JAX
package's (``feddat_tpu/study.py``) on the CPU, at the study's tiny shapes.

* The synthetic clients: every array, the brightness threshold and every
  batch of ``train_batches(0)``, ``train_batches(1)`` and ``eval_batches()``
  bitwise JAX's, for two seeds and two client indices.
* ``format_study``: character for character JAX's.
* The full-width configurations: the same model configs, dtypes and
  attention routes as JAX's, and the same refusal (NORM on ``"layer"``).
* Paired runs: ``run_study`` of each package, mode ``dat``, seed 0, two
  clients, the port's ``_build_family`` handing JAX's initial parameters
  (carried across by ``utils/param_bridge.py``) to the port's engine; ViLT
  over 2 rounds, ALBEF over 1.  Each engine records its step metrics.
  Tolerances: step losses rtol 1e-4 (fp32 on both sides; the frameworks sum
  in other orders, and Adam turns a near-zero gradient's summation-order
  difference into up to a step of size lr in that element, so later losses
  drift by more than one ulp); each client's three scores equal, or at most
  one eval example apart (100/16 points for ViLT, 100/8 for ALBEF) where an
  argmax sits at a near-tie.  The study's tiny ALBEF has the BERT towers'
  dropout 0.1 live, and the port's masks cannot match JAX's mask for mask
  (``utils/seeding.py``), so the paired ALBEF run sets both rates to 0 on
  both sides (the port's ALBEF trains with dropout live in
  ``tests/test_torch_albef_train.py``).  Both packages write the paired
  runs' history files, whose names and schema must agree.
* The port-only tiny zoo (``lora,bias,prompt``) with the schema checks of
  ``tests/test_accuracy_study.py``.
* ``run_study()`` with no device on a host without CUDA raises.

Run as a script, the file pairs the two packages over more rounds, clients
and modes (the ALBEF family with its BERT dropout off on both sides):

    env JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_study.py [--family vilt|albef]
        [--rounds 8] [--clients 4] [--modes none,adapter,dat]

and prints, per mode, the steps compared, the largest relative difference of
the step losses (over all steps and over the first half), the last loss of
each, and each package's final scores.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import feddat_tpu.federated.engine as jax_engine
import feddat_tpu.study as jstudy
import feddat_tpu_torch.study as tstudy
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu_torch.configs.core import PEFTMode
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax

LOSS_RTOL = 1e-4
TINY_VILT = dict(num_train=32, num_eval=16, vocab_size=64, text_len=8, image_size=(32, 32),
                 batch_size=8, val_batch_size=8)
TINY_ALBEF = dict(num_train=16, num_eval=8, vocab_size=64, question_len=8, answer_len=6,
                  image_size=(32, 32), batch_size=4, val_batch_size=4)
CLIENTS = [("HeterogeneousVQAClient", TINY_VILT), ("HeterogeneousAlbefClient", TINY_ALBEF)]


def _assert_batches_equal(want, got):
    want, got = list(want), list(got)
    assert len(want) == len(got) > 0
    for wb, gb in zip(want, got):
        assert wb.keys() == gb.keys()
        for k in wb:
            assert wb[k].dtype == gb[k].dtype, k
            np.testing.assert_array_equal(wb[k], gb[k], err_msg=k)


@pytest.mark.parametrize("cls,sizes", CLIENTS, ids=["vilt", "albef"])
@pytest.mark.parametrize("seed,idx", [(0, 0), (0, 3), (2, 1), (2, 3)])
def test_clients_are_bitwise_jax(cls, sizes, seed, idx):
    want = getattr(jstudy, cls)(task_key=f"client_{idx}", client_idx=idx, seed=seed, **sizes)
    got = getattr(tstudy, cls)(task_key=f"client_{idx}", client_idx=idx, seed=seed, **sizes)
    arrays = {k: v for k, v in vars(want).items() if isinstance(v, np.ndarray)}
    assert len(arrays) >= 5 and set(arrays) == {k for k, v in vars(got).items()
                                                 if isinstance(v, np.ndarray)}
    for k, v in arrays.items():
        assert v.dtype == getattr(got, k).dtype, k
        np.testing.assert_array_equal(v, getattr(got, k), err_msg=k)
    assert got.brightness_threshold == want.brightness_threshold
    assert got.steps_per_epoch == want.steps_per_epoch
    for epoch in (0, 1):
        _assert_batches_equal(want.train_batches(epoch), got.train_batches(epoch))
    _assert_batches_equal(want.eval_batches(), got.eval_batches())


def test_constants_match_jax():
    for name in ("K_SHARED", "NUM_LABELS", "PERSONAL_Q_TOKEN", "SHARED_Q_BASE"):
        assert getattr(tstudy, name) == getattr(jstudy, name), name


@pytest.mark.parametrize("mode,attn_impl", [("dat", None), ("dat", "layer"), ("adapter", "block"),
                                            ("none", None), ("lora", None), ("norm", "block"),
                                            ("prompt", None)])
def test_full_width_configs_match_jax(mode, attn_impl):
    """``_study_model``/``_study_albef_model`` at full scale: JAX's configs,
    dtypes and routes (the model is built on the meta device here)."""
    jm, jcfg = jstudy._study_model(JaxPEFTMode(mode), True, 4, attn_impl)
    tm, tcfg = tstudy._study_model(PEFTMode(mode), True, 4, attn_impl)
    assert dataclasses.asdict(tcfg) == {**dataclasses.asdict(jcfg), "adapter": {
        **dataclasses.asdict(jcfg.adapter), "fused": False}}
    assert tm.attn_impl == jm.attn_impl and str(tm.dtype).split(".")[-1] == jm.dtype.__name__
    assert set(tm.task_heads) == {f"client_{i}" for i in range(4)}
    assert tm.task_heads["client_0"].num_labels == tstudy.NUM_LABELS
    if mode in ("lora", "prompt", "norm"):
        return
    ja, jacfg = jstudy._study_albef_model(JaxPEFTMode(mode), True, attn_impl)
    ta, tacfg = tstudy._study_albef_model(PEFTMode(mode), True, attn_impl)
    assert dataclasses.asdict(tacfg) == {**dataclasses.asdict(jacfg), "adapter": {
        **dataclasses.asdict(jacfg.adapter), "fused": False}}
    assert ta.visual_encoder.attn_impl == ja.vision_attn_impl == (attn_impl or "block")
    assert ta.dtype == torch.bfloat16


def test_norm_on_layer_raises_as_in_jax():
    for build in ("_study_model", "_study_albef_model"):
        args = (PEFTMode.NORM, True, 4, "layer") if build == "_study_model" else (
            PEFTMode.NORM, True, "layer")
        with pytest.raises(ValueError, match="incompatible with PEFT mode 'norm'"):
            getattr(tstudy, build)(*args)


class _Steps:
    """A metrics logger that keeps each step's scalars (both engines call
    ``step(metrics, batch_size, task_key)`` and ``round(...)``)."""

    def __init__(self, out):
        self.out = out

    def step(self, metrics, batch_size, task_key):
        self.out.append((task_key, {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0}))

    def round(self, round_idx, scores, wall_s):
        pass


def _recording(cls, out):
    class Recording(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, metrics_logger=_Steps(out), **kwargs)

    return Recording


def _without_dropout(build):
    """Wrap a package's ``_study_albef_model``: the same model with the BERT
    towers' dropout rates at 0."""

    def wrapped(mode, full_scale, attn_impl=None):
        model, cfg = build(mode, full_scale, attn_impl)
        cfg = dataclasses.replace(cfg, bert=dataclasses.replace(cfg.bert, hidden_dropout=0.0,
                                                                attention_dropout=0.0))
        if isinstance(model, torch.nn.Module):
            with torch.device("meta"):
                return type(model)(cfg, dtype=model.dtype), cfg
        return type(model)(cfg, dtype=model.dtype), cfg

    return wrapped


def _shared_steps(make):
    """``make_dat_train_step`` memoised on what fixes the step's function: the
    forward, the partitions, the optimizer and the horizon."""
    made = {}

    def shared(forward, part, opt_cfg, max_steps, **kw):
        key = (id(forward), part.shared_paths, part.local_paths, part.head_paths, opt_cfg,
               max_steps, tuple(sorted(kw.items())))
        if key not in made:
            made[key] = make(forward, part, opt_cfg, max_steps, **kw)
        return made[key]

    return shared


def _paired(family, rounds, modes=("dat",), clients=2, out_dirs=(None, None)):
    """-> (JAX results, port results, JAX step records, port step records)
    of ``run_study`` over ``modes``, seed 0, ``clients`` clients, the port
    starting each run from JAX's initial parameters for its mode and seed;
    ``out_dirs``: where each package writes its history files."""
    kw = dict(modes=modes, seeds=(0,), num_clients=clients, comm_rounds=rounds, family=family)
    jsteps, tsteps, captured = [], [], {}
    j_build, t_build = jstudy._build_family, tstudy._build_family

    def jax_build(family, mode, full_scale, num_clients, clients, seed, **kwargs):
        model, params, engine_kw = j_build(family, mode, full_scale, num_clients, clients, seed,
                                           **kwargs)
        captured[mode.value, seed] = params
        if family == "albef":  # one forward for every client (it takes no task key)
            forward = engine_kw["make_forward"](model, None)
            engine_kw = {**engine_kw, "make_forward": lambda mdl, task_key: forward}
        return model, params, engine_kw

    def port_build(family, mode, full_scale, num_clients, clients, seed, **kwargs):
        model, params, engine_kw = t_build(family, mode, full_scale, num_clients, clients, seed,
                                           **kwargs)
        bridge = vilt_from_flax if family == "vilt" else albef_from_flax
        carried = bridge(jax.tree_util.tree_map(np.asarray, captured[mode.value, seed]))
        assert {k: v.shape for k, v in carried.items()} == {k: v.shape for k, v in params.items()}
        return model, carried, engine_kw

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstudy, "_build_family", jax_build)
        mp.setattr(jax_engine, "FederatedTrainer", _recording(jax_engine.FederatedTrainer, jsteps))
        mp.setattr(tstudy, "_build_family", port_build)
        mp.setattr(tstudy, "FederatedTrainer", _recording(tstudy.FederatedTrainer, tsteps))
        if family == "albef":
            # ALBEF's clients train one function (one forward, its one cls head):
            # one JAX compile of their DAT step, as the port shares one program
            mp.setattr(jax_engine, "make_dat_train_step", _shared_steps(jax_engine.make_dat_train_step))
            mp.setattr(jstudy, "_study_albef_model", _without_dropout(jstudy._study_albef_model))
            mp.setattr(tstudy, "_study_albef_model", _without_dropout(tstudy._study_albef_model))
        jres = jstudy.run_study(full_scale=False, out_dir=out_dirs[0], **kw)
        tres = tstudy.run_study(device="cpu", out_dir=out_dirs[1], **kw)
    return jres, tres, jsteps, tsteps


def _out_dirs(factory, family):
    return tuple(str(factory.mktemp(f"{family}_{side}")) for side in ("jax", "port"))


@pytest.fixture(scope="module")
def vilt_runs(tmp_path_factory):
    dirs = _out_dirs(tmp_path_factory, "vilt")
    return _paired("vilt", 2, out_dirs=dirs) + (dirs,)


@pytest.fixture(scope="module")
def albef_runs(tmp_path_factory):
    dirs = _out_dirs(tmp_path_factory, "albef")
    return _paired("albef", 1, out_dirs=dirs) + (dirs,)


@pytest.mark.parametrize("family", ["vilt", "albef"])
def test_paired_dat_run_matches_jax(family, request):
    jres, tres, jsteps, tsteps, _ = request.getfixturevalue(f"{family}_runs")
    n_eval = (TINY_VILT if family == "vilt" else TINY_ALBEF)["num_eval"]
    rounds = 2 if family == "vilt" else 1
    # 2 clients x rounds x steps per epoch, in the same order
    steps = (TINY_VILT["num_train"] // 8 if family == "vilt" else TINY_ALBEF["num_train"] // 4)
    assert len(tsteps) == len(jsteps) == 2 * rounds * steps
    for i, ((jk, jm), (tk, tm)) in enumerate(zip(jsteps, tsteps)):
        assert jk == tk
        keys = set(jm) & set(tm)
        assert {"loss", "loss_shared"} <= keys
        for k in sorted(keys):
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=f"step {i} ({tk}) {k}")
    (jh,), (th,) = jres["dat"]["histories"], tres["dat"]["histories"]
    assert len(th) == len(jh) == 1  # eval_every = comm_rounds: one evaluation
    assert th[0]["round"] == jh[0]["round"] == rounds - 1
    assert th[0]["scores"].keys() == jh[0]["scores"].keys() == {"client_0", "client_1"}
    for key, want in jh[0]["scores"].items():
        got = th[0]["scores"][key]
        assert len(got) == len(want) == 3  # ensemble, local, shared
        np.testing.assert_allclose(got, want, rtol=0, atol=100.0 / n_eval + 1e-9, err_msg=key)
    assert set(tres["dat"]["table"]) == {"client_0", "client_1", "average"}


def test_format_study_matches_jax(vilt_runs):
    jres, tres, _, _, _ = vilt_runs
    assert tstudy.format_study(jres) == jstudy.format_study(jres)
    assert tstudy.format_study(tres) == jstudy.format_study(tres)
    gap = {"a": {"table": {"t0": {"mean": 12.3456, "std": 0.5, "n": 3},
                           "average": {"mean": 12.3456, "std": 0.0, "n": 1}}},
           "b": {"table": {"average": {"mean": 1.0, "std": 2.0, "n": 1}}}}
    assert tstudy.format_study(gap) == jstudy.format_study(gap)
    assert "—" in tstudy.format_study(gap)


def _schema(value):
    """A JSON value's structure: dict keys and list lengths, floats as
    ``float``."""
    if isinstance(value, dict):
        return {k: _schema(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_schema(v) for v in value]
    return type(value).__name__


@pytest.mark.parametrize("family", ["vilt", "albef"])
def test_history_files(family, request):
    """The paired runs' history files: the same names as JAX's run_study
    writes, each the run's history, with JAX's schema."""
    jres, tres, _, _, (jdir, tdir) = request.getfixturevalue(f"{family}_runs")
    name = f"{'albef_' if family == 'albef' else ''}dat_seed0.history.json"
    jdir, tdir = pathlib.Path(jdir), pathlib.Path(tdir)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(p.name for p in jdir.iterdir()) == [name]
    want, got = json.loads((jdir / name).read_text()), json.loads((tdir / name).read_text())
    assert got == tres["dat"]["histories"][0]
    assert _schema(got) == _schema(want)
    assert all(0.0 <= s <= 100.0 for scores in got[-1]["scores"].values() for s in scores)


def test_run_study_smoke_peft_zoo():
    results = tstudy.run_study(modes=("lora", "bias", "prompt"), seeds=(0,), num_clients=2,
                               comm_rounds=2, device="cpu")
    for mode in ("lora", "bias", "prompt"):
        table = results[mode]["table"]
        assert set(table) == {"client_0", "client_1", "average"}
        hist = results[mode]["histories"][0]
        # non-DAT modes report a single scalar eval score per task
        score = hist[-1]["scores"]["client_0"]
        assert isinstance(score, float)
        assert 0.0 <= score <= 100.0


def test_run_study_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tstudy.run_study()
    with pytest.raises(ValueError, match="unknown family"):
        tstudy.run_study(family="flava", device="cpu")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser("test_torch_study")
    p.add_argument("--family", default="vilt", choices=["vilt", "albef"])
    p.add_argument("--rounds", type=int, default=8)
    p.add_argument("--clients", type=int, default=4)
    p.add_argument("--modes", default="none,adapter,dat")
    args = p.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    for mode in args.modes.split(","):
        jres, tres, jsteps, tsteps = _paired(args.family, args.rounds, (mode,), args.clients)
        assert [k for k, _ in jsteps] == [k for k, _ in tsteps]
        jl = np.array([m["loss"] for _, m in jsteps])
        tl = np.array([m["loss"] for _, m in tsteps])
        rel = np.abs(tl - jl) / np.abs(jl)
        print(f"{args.family} {mode}: {len(jl)} steps, step loss relative difference max "
              f"{rel.max():.2e} (first half {rel[:len(rel) // 2].max():.2e}); last loss JAX "
              f"{jl[-1]:.6f}, port {tl[-1]:.6f}")
        print(f"  JAX  {json.dumps(jres[mode]['histories'][0][-1]['scores'])}")
        print(f"  port {json.dumps(tres[mode]['histories'][0][-1]['scores'])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
