"""The port's compiled steps and forwards (``feddat_tpu_torch/train/compiled.py``)
on the CPU, where the same plumbing as on the card (prologue, static buffers,
device-tensor scalars, persistent generators, hand-back) runs the body
eagerly; and the shape gates that route sites off a kernel's limits.

* (a) each train step through the plumbing, 3 steps, bitwise against the
  same step under ``disable_graphs()`` (the body on the caller's tensors):
  states, losses, gradient sets; the state passed in stays valid, and every
  input is copied into its static buffer at every call;
* (b) the fused DAT step through the plumbing against JAX's jitted
  ``make_dat_train_step_fused`` over 3 steps, at tests/test_torch_train.py's
  tolerance (losses rtol=2e-5; parameters rtol=1e-4, atol=1e-6);
* (c) ``apply_direction`` with 0-dim tensor lr and bias corrections, bitwise
  against Python floats;
* (d) every device body with the host reads a capture cannot take
  (``Tensor.item``, ``__float__``, ``__int__``, ``__bool__``, ``tolist``,
  ``cpu``, ``numpy``) made to raise;
* (e) ALBEF with dropout live through the plumbing: the same state gives
  bitwise equal steps, another seed other losses;
* (f) the gates of #4's, #2's and the block route's shape limits;
* the predictors and an eval step called inside ``torch.inference_mode()``;
* a resident input handed back by an earlier call and passed again after a
  later call updated it in place raises, graphs on or off, as JAX raises on
  a donated buffer used again."""

import contextlib

import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.train import dat as jdat
from feddat_tpu_torch.configs.core import AdapterSpec, LoraSpec, OptimizerConfig, PEFTMode
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.models import layers as tlayers
from feddat_tpu_torch.models.albef import AlbefModel
from feddat_tpu_torch.ops import adapter_fused as af
from feddat_tpu_torch.ops import attn_block as ab
from feddat_tpu_torch.ops import layer_block as lb
from feddat_tpu_torch.serving import AlbefVqaPredictor, ViltVqaPredictor
from feddat_tpu_torch.train import compiled
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import optim as toptim
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.train.evaluation import make_albef_eval_step, make_eval_step
from feddat_tpu_torch.train.forwards import make_vilt_forward, make_vilt_fused_parts, to_device
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax

from conftest import TINY_VILT, tiny_batch
from test_torch_albef import LQ, port_config, weights  # noqa: F401  (module fixture)
from test_torch_albef_train import LIVE, _train_batch
from test_torch_train import _jax_fused_step
from test_torch_vilt import jax_model_and_params, port_model

HEADS = {"coco": dict(num_labels=16)}
OPT = dict(lr=1e-2, weight_decay=1e-2)
STEPS = ("standard", "fused", "plain", "albef_fused")


@pytest.fixture(scope="module")
def vilt():
    jmodel, params = jax_model_and_params(TINY_VILT, heads=HEADS)
    return jmodel, params, port_model(TINY_VILT, params, "auto", HEADS)


def _sd(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def _vilt_batch(seed):
    batch = tiny_batch(np.random.RandomState(seed))
    batch["attention_mask"][0, 5:] = 0
    return to_device(batch, torch.device("cpu"))


def _step(kind, vilt, albef_weights):
    """-> (compiled step, initial state, batch) of one of the four steps."""
    opt = OptimizerConfig(**OPT)
    if kind == "albef_fused":
        model = AlbefModel(port_config(LIVE))
        model.load_state_dict(albef_from_flax(albef_weights), strict=True)
        sd = _sd(model)
        step, part = trainers.make_albef_fused_dat_step(model, sd, opt, 100)
        batch = to_device(_train_batch(5), torch.device("cpu"))
    else:
        model = vilt[2]
        sd = _sd(model)
        mode = PEFTMode.BIAS if kind == "plain" else PEFTMode.DAT
        part = tdat.Partitioner(sd, "coco", mode)
        if kind == "standard":
            step = tdat.make_dat_train_step(make_vilt_forward(model, "coco"), part, opt, 100)
        elif kind == "fused":
            step = tdat.make_dat_train_step_fused(*make_vilt_fused_parts(model, "coco"), part, opt, 100)
        else:
            step = tdat.make_plain_train_step(make_vilt_forward(model, "coco"), part, opt, 100)
        batch = _vilt_batch(5)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(3))
    return step, state, batch


def _tree_equal(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _tree_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


def _state_equal(a, b):
    assert a.sched_count == b.sched_count
    _tree_equal(a.params, b.params, "params")
    for name in a.opt_states:
        sa, sb = a.opt_states[name], b.opt_states[name]
        assert sa.count == sb.count
        _tree_equal({"mu": sa.mu, "nu": sa.nu}, {"mu": sb.mu, "nu": sb.nu}, name)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


@pytest.mark.parametrize("kind", STEPS)
def test_plumbing_matches_the_eager_step_bitwise(kind, vilt, weights, monkeypatch):
    step, state0, batch = _step(kind, vilt, weights)
    before = {k: v.clone() for k, v in state0.params.items()}
    fills = []
    real_fill = compiled._fill

    def spy(bufs, srcs):
        fills.extend(srcs)
        real_fill(bufs, srcs)

    monkeypatch.setattr(compiled, "_fill", spy)
    runs = {}
    for eager in (False, True):
        state, out = state0, []
        with compiled.disable_graphs() if eager else contextlib.nullcontext():
            for i in range(3):
                fills.clear()
                prev = state
                state, metrics = step(state, batch)
                out.append(metrics)
                # every input goes into its static buffer at every call
                n_inputs = (len(prev.params) + len(batch) + 1
                            + sum(2 * len(s.mu) for s in prev.opt_states.values()))
                assert len(fills) == (0 if eager else n_inputs)
        runs[eager] = (state, out)
    _state_equal(runs[False][0], runs[True][0])
    for got, want in zip(runs[False][1], runs[True][1]):
        _tree_equal(got, want, kind)
    assert runs[False][0].sched_count == (6 if kind != "plain" else 3)
    if kind != "plain":
        assert set(runs[False][1][0]["grads"]) == {"shared", "head_2", "local", "head_3"}
    for k, v in before.items():  # the state passed in stays valid
        assert torch.equal(state0.params[k], v), k
    assert compiled._ENABLED  # disable_graphs() restores the switch


@pytest.fixture(scope="module")
def jax_fused_trajectory(vilt):
    import jax

    jmodel, params, _ = vilt
    batch = tiny_batch(np.random.RandomState(5))
    batch["attention_mask"][0, 5:] = 0
    part = jdat.Partitioner(params, "coco", JaxPEFTMode.DAT)
    opt = JaxOptimizerConfig(**OPT)
    step = _jax_fused_step(jmodel, params, part, opt)
    state = jdat.init_train_state(params, part, opt, jax.random.PRNGKey(0))
    traj = []
    for _ in range(3):
        state, m = step(state, batch)
        traj.append((float(m["loss"]), float(m["loss_shared"]),
                     jax.tree_util.tree_map(np.asarray, state.params)))
    return traj


def test_fused_step_through_the_plumbing_matches_jax(vilt, jax_fused_trajectory):
    step, state, batch = _step("fused", vilt, None)
    assert isinstance(step, compiled.Compiled)
    eager_before = compiled.STATS["eager"]
    for loss, loss_shared, jparams in jax_fused_trajectory:
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-5)
        np.testing.assert_allclose(float(m["loss_shared"]), loss_shared, rtol=2e-5)
        for k, v in vilt_from_flax(jparams).items():
            np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert compiled.STATS["eager"] == eager_before + 3  # the CPU runs the plumbing, no capture


@pytest.mark.parametrize("start", [0, 7])
def test_apply_direction_takes_device_scalars_bitwise(start):
    rng = np.random.RandomState(start)
    shapes = {"vilt.pooler.weight": (6, 5), "vilt.pooler.bias": (6,),
              "vilt.final_norm.weight": (6,)}
    params = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
    tx = toptim.adamw_direction(OptimizerConfig(lr=3e-3, weight_decay=0.1))
    lr_at = toptim.polynomial_schedule(OptimizerConfig(lr=3e-3, warmup_ratio=0.2), 20)
    state = toptim.AdamState(start, *(tx.init(params).mu, tx.init(params).nu))
    p_f, s_f, p_t, s_t = params, state, params, state
    for i in range(3):
        grads = {k: torch.from_numpy(rng.randn(*s).astype(np.float32)) for k, s in shapes.items()}
        lr = lr_at(start + i)
        p_f, s_f = toptim.apply_direction(tx, grads, s_f, p_f, lr)
        bc = tuple(torch.tensor(v, dtype=torch.float32) for v in tx.bias_correction(s_t.count + 1))
        p_t, s_t = toptim.apply_direction(tx, grads, s_t, p_t, torch.tensor(lr, dtype=torch.float32),
                                          bc)
        assert s_f.count == s_t.count == start + i + 1
        for k in shapes:
            assert torch.equal(p_f[k], p_t[k]) and torch.equal(s_f.mu[k], s_t.mu[k]) \
                and torch.equal(s_f.nu[k], s_t.nu[k]), k


HOST_READS = ("item", "__float__", "__int__", "__bool__", "tolist", "cpu", "numpy")


@contextlib.contextmanager
def _no_host_reads():
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"Tensor.{name} inside a device body")
        return read

    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _guarded(program):
    body = program.body

    def run(inputs, gens):
        with _no_host_reads():
            return body(inputs, gens)

    program.body = run


def _albef_predictor(weights):
    model = AlbefModel(port_config(LIVE))
    model.load_state_dict(albef_from_flax(weights), strict=True)
    words = ["what", "is", "the", "color", "red", "blue", "two", "cat"]
    return AlbefVqaPredictor(model, None, WordPieceTokenizer.toy(words), ["red", "blue", "two cat"],
                             batch_size=2, k=2, max_question_len=LQ, max_answer_len=4,
                             device="cpu")


@pytest.mark.parametrize("body", STEPS + ("eval", "albef_eval", "vilt_forward", "albef_rank"))
def test_device_bodies_read_nothing_from_the_host(body, vilt, weights):
    if body in STEPS:
        step, state, batch = _step(body, vilt, weights)
        _guarded(step.program)
        step(step(state, batch)[0], batch)
        return
    if body == "eval":
        sd = _sd(vilt[2])
        step = make_eval_step(vilt[2], "coco")
        _guarded(step.program)
        batch = tiny_batch(np.random.RandomState(2))
        batch["valid"] = np.array([1, 1, 1, 0], np.float32)
        for mode in ("ensemble", "adapter_0"):
            assert torch.isfinite(step(sd, batch, adapter_mode=mode))
    elif body == "albef_eval":
        pred = _albef_predictor(weights)
        sd = _sd(pred.model)
        step = make_albef_eval_step(pred.model, *(t.numpy() for t in pred.bank), k=2)
        _guarded(step.program)
        batch = {k: v for k, v in _train_batch(3).items() if k.startswith(("pixel", "question"))}
        batch["gt_labels"] = np.array([[0, -1], [2, 1]], np.int32)
        assert 0 <= float(step(sd, batch, adapter_mode="ensemble")) <= 2
    elif body == "vilt_forward":
        pred = _vilt_predictor(vilt[2])
        _guarded(pred._forward.program)
        from PIL import Image

        imgs = [Image.fromarray(np.full((20, 30, 3), 40 * i, np.uint8)) for i in range(2)]
        probs = pred.forward(pred._preprocess(imgs, ["a b", "b"]))
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)
    else:
        pred = _albef_predictor(weights)
        _guarded(pred._rank.program)
        batch = {"pixel_values": np.random.RandomState(1).randint(0, 255, (2, 32, 32, 3), np.uint8),
                 "question_ids": np.full((2, LQ), 5, np.int32),
                 "question_mask": np.ones((2, LQ), np.int32)}
        ids, probs = pred.rank(batch)
        assert ids.shape == probs.shape == (2, 2)


def test_albef_dropout_through_the_plumbing_is_a_function_of_the_state(weights):
    step, state0, batch = _step("albef_fused", None, weights)
    assert trainers.model_dropout_rate(AlbefModel(port_config(LIVE))) == 0.1

    def run(seed, eager=False):
        state = state0.replace(rng=torch.Generator().manual_seed(seed))
        with compiled.disable_graphs() if eager else contextlib.nullcontext():
            state, m1 = step(state, batch)
            _, m2 = step(state, batch)
        return [float(m[k]) for m in (m1, m2) for k in ("loss", "loss_shared")]

    a, b, c, d = run(7), run(7), run(8), run(7, eager=True)
    assert a == b == d
    assert all(x != y for x, y in zip(a, c))
    assert len(step.program.entries) == 1  # one signature, its generators re-seeded per call


@pytest.mark.parametrize("r", [8, 16, 48, 64, 96, 128, 192])
def test_gates_route_bottlenecks_the_kernels_do_not_take(r, monkeypatch):
    """The layer route takes every bottleneck: #4's wrapper pads any of them
    to its chunks, so the port's gate has JAX's terms and no bottleneck one
    (nothing is routed the "block" way any more); #2 takes every bottleneck
    (past 128 in chunks) and every width (a width that is no multiple of 64
    through zero-padded copies), as JAX's kernel does, and its wrapper
    raises only at a width or bottleneck below 1."""
    monkeypatch.delenv("FEDDAT_LAYER_MAX_S", raising=False)
    assert not hasattr(tlayers, "layer_route_takes") and not hasattr(lb, "takes_bottleneck")
    assert lb.padded_bottleneck(r, False) >= r and lb.padded_bottleneck(r, True) >= r
    assert af.takes(768, r)
    assert af.takes(1280, 80) and af.takes(2048, 128) and af.takes(64, 1)
    assert af.takes(800, 50) and af.takes(48, r) and af.takes(1, 1)
    assert af.padded_width(800) == 832 and af.padded_width(48) == 64 and af.padded_width(768) == 768
    assert not af.takes(0, 8) and not af.takes(768, 0)
    spec = AdapterSpec(names=("adapter_0", "adapter_1", "adapter_2"), reduction_factor=768 // r)
    layer = tlayers.PreLNLayer(768, 12, 64, spec, attn_impl="layer")
    assert layer.adapter.bottleneck == r  # what the gates ask
    for mode in ("adapter_0", "ensemble"):
        assert layer.takes_layer_kernel(torch.zeros(1, 185, 768), None, mode, True, None)


@pytest.mark.parametrize("s", [768, 769])
def test_block_gate_sends_long_sequences_down_the_composable_route(s, monkeypatch):
    """JAX's block gate (layers.py:163-173) has no sequence cap and neither
    has the port's: a block site at any S goes to #1/#3's wrapper, never down
    the composable route.  On the card the kernels take any S (their
    attention cores keep no logits tile); here the wrapper's plain version
    runs the site, equal to the "auto" route."""
    assert tlayers.attn_block_eligible("block", None, LoraSpec(), 0.0, True)
    assert not tlayers.attn_block_eligible("auto", None, LoraSpec(), 0.0, True)
    seen = []
    real = ab.attn_block

    def spy(x, *args, **kwargs):
        seen.append(x.shape[1])
        return real(x, *args, **kwargs)

    monkeypatch.setattr(ab, "attn_block", spy)
    torch.manual_seed(s)
    x = torch.randn(1, s, 128)
    block = tlayers.MultiHeadAttention(128, 2, attn_impl="block")
    auto = tlayers.MultiHeadAttention(128, 2, attn_impl="auto")
    auto.load_state_dict(block.state_dict())
    with torch.no_grad():
        got, want = block(x), auto(x)
    assert seen == [s]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _vilt_predictor(model):
    return ViltVqaPredictor(model, None, "coco", WordPieceTokenizer.toy(["a", "b"]),
                            [str(i) for i in range(16)], batch_size=2,
                            canvas=TINY_VILT.image_size, max_text_len=TINY_VILT.max_text_len,
                            device="cpu")


@pytest.mark.parametrize("call", ["vilt_forward", "albef_rank", "eval"])
def test_compiled_calls_run_inside_inference_mode(call, vilt, weights):
    """Inputs made inside ``torch.inference_mode()`` are inference tensors;
    the static buffers take them, and calls inside and outside the mode
    give the eager results."""
    if call == "vilt_forward":
        from PIL import Image

        pred = _vilt_predictor(vilt[2])
        imgs = [Image.fromarray(np.full((20, 30, 3), 40 * i, np.uint8)) for i in range(2)]
        batch = pred._preprocess(imgs, ["a b", "b"])

        def run():
            return [pred.forward(batch)]
    elif call == "albef_rank":
        pred = _albef_predictor(weights)
        batch = {"pixel_values": np.random.RandomState(1).randint(0, 255, (2, 32, 32, 3), np.uint8),
                 "question_ids": np.full((2, LQ), 5, np.int32),
                 "question_mask": np.ones((2, LQ), np.int32)}

        def run():
            return list(pred.rank(batch))
    else:
        sd = _sd(vilt[2])
        step = make_eval_step(vilt[2], "coco")
        batch = tiny_batch(np.random.RandomState(2))

        def run():
            return [step(sd, batch, adapter_mode="ensemble").numpy()]
    with compiled.disable_graphs():
        want = run()
    outs = []
    for mode in (True, True, False, True):
        with torch.inference_mode(mode):
            outs.append(run())
    for got in outs:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("graphs", [True, False], ids=["plumbing", "eager"])
def test_a_stale_resident_input_raises(graphs):
    """Each call hands the resident dict back tagged with its generation: the
    last one passes again (and is updated in place), an older one raises; a
    fresh dict is copied and never written."""
    def body(inp, gens):
        inp["aux"]["t"].add_(inp["x"])
        return {"aux": inp["aux"], "y": inp["aux"]["t"] * 2}

    prog = compiled.Program(body, "resident_probe", resident=("aux",))
    seed = {"t": torch.zeros(3)}
    ctx = contextlib.nullcontext() if graphs else compiled.disable_graphs()
    with ctx:
        first = prog({"aux": seed, "x": torch.ones(3)})
        second = prog({"aux": first["aux"], "x": torch.ones(3)})
        assert isinstance(second["aux"], compiled.ResidentDict)
        assert second["aux"]["t"] is first["aux"]["t"]
        np.testing.assert_array_equal(second["y"].numpy(), np.full(3, 4.0))
        with pytest.raises(RuntimeError, match="resident input 'aux' of call 1 passed again after call 2"):
            prog({"aux": first["aux"], "x": torch.ones(3)})
        third = prog({"aux": second["aux"], "x": torch.ones(3)})
        np.testing.assert_array_equal(third["aux"]["t"].numpy(), np.full(3, 3.0))
        fresh = prog({"aux": {"t": torch.zeros(3)}, "x": torch.ones(3)})
        np.testing.assert_array_equal(fresh["aux"]["t"].numpy(), np.ones(3))
    assert torch.equal(seed["t"], torch.zeros(3))


def test_captures_run_thread_local_while_a_process_group_lives():
    """A live process group's watchdog thread calls into CUDA at any time, so
    every capture made while one exists runs in the "thread_local" mode,
    whether or not its body all-reduces."""
    from feddat_tpu_torch.parallel import mesh as tmesh

    assert compiled.capture_mode() == "global"
    with tmesh.world(torch.device("cpu")):
        assert compiled.capture_mode() == "thread_local"
    assert compiled.capture_mode() == "global"
