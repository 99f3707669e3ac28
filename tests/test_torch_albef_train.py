"""The port's ALBEF DAT training against the JAX package on the CPU (tiny
widths, the JAX-initialised weights of tests/test_torch_albef.py through
``albef_from_flax``): the training forward and its pieces, the standard and
fused DAT steps over 2 steps with their four gradient sets, the port's fused
step against its standard step, one federated round, the synthetic client,
and dropout, which cannot match JAX mask for mask: a mask unit test, masks
from explicit generators only, flash at the ViT sites only, and loss means
against JAX's by distribution.  JAX runs its Pallas flash kernels in interpret
mode; the port runs their plain versions.

Tolerances: forwards fp32 rtol=1e-4, atol=1e-5 (one fp32 function summed in
another order).  Steps, the rule of tests/test_torch_train.py: losses
rtol=2e-5, parameters rtol=1e-4 and atol=lr/50 (Adam turns the summation
noise of a near-zero gradient element into up to a step of size lr); the
gradient sets by relative Frobenius norm per set, at most 1e-4.  The fused
step against the standard one: losses rtol=1e-5, parameters rtol=5e-4,
atol=1e-6, as tests/test_dat_fused.py holds them in JAX."""

import contextlib
import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticAlbefClient as JaxAlbefClient
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.albef import momentum_update as jax_momentum_update
from feddat_tpu.train import dat as jdat
from feddat_tpu.train import optim as joptim
from feddat_tpu.train import trainers as jtrainers
from feddat_tpu.train.evaluation import make_albef_eval_step as jax_make_albef_eval_step
from feddat_tpu.train.forwards import make_albef_forward as jax_make_albef_forward
from feddat_tpu.train.losses import kd_kl_loss as jax_kd_kl_loss
from feddat_tpu.train.trainers import make_albef_fused_dat_step as jax_make_albef_fused_dat_step
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.models.albef import AlbefModel, momentum_update
from feddat_tpu_torch.ops import attention as tattention
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.train.forwards import make_albef_forward, to_device
from feddat_tpu_torch.utils import seeding
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_albef import LQ, LA, TINY, _jax_apply, port_config, port_model, to_torch, weights  # noqa: F401

RTOL, ATOL = 1e-4, 1e-5
OPT = dict(lr=1e-2)
LIVE = dataclasses.replace(TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.1,
                                                          attention_dropout=0.1))
CLIENT = dict(num_train=8, num_eval=4, num_answers=8, vocab_size=TINY.bert.vocab_size,
              question_len=LQ, answer_len=LA, max_answers_per_q=2, image_size=(32, 32),
              batch_size=4, val_batch_size=4)


def _train_batch(seed, b=2, a=3):
    """ALBEF's train schema: questions with padding, A answers per question
    with padded tokens (target -100) and a zero-weight slot."""
    rng = np.random.RandomState(seed)
    batch = {
        "pixel_values": rng.randn(b, 32, 32, 3).astype(np.float32),
        "question_ids": rng.randint(5, 90, (b, LQ)).astype(np.int32),
        "question_mask": np.ones((b, LQ), np.int32),
        "answer_ids": rng.randint(5, 90, (b, a, LA)).astype(np.int32),
        "answer_mask": np.ones((b, a, LA), np.int32),
        "answer_weights": rng.rand(b, a).astype(np.float32),
    }
    batch["question_mask"][0, LQ - 3:] = 0
    batch["question_ids"][0, LQ - 3:] = 0
    batch["answer_ids"][:, :, 0] = 1
    batch["answer_mask"][1, 0, 2:] = 0
    batch["answer_ids"][1, 0, 2:] = 0
    batch["answer_weights"][0, a - 1] = 0.0
    return batch


def _sd(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_train_forward_and_pieces_match_jax(weights, attn_impl):
    """``forward`` (JAX's ``__call__``: the weighted LM loss / B and the
    shifted logits), ``encode_train``, and ``apply_cls`` on JAX's hidden
    states against JAX's shifted logits (JAX's ``__call__`` is ``apply_cls``
    of ``encode_train``); ``forward_train_logits`` is the two in a row."""
    batch = _train_batch(1)
    kw = dict(attn_impl=attn_impl, params=weights)
    j_loss, j_logits = _jax_apply(JaxAlbef.__call__, batch, "ensemble", deterministic=True, **kw)
    j_hidden = np.array(_jax_apply(JaxAlbef.encode_train, batch, "ensemble", **kw))
    model, t = port_model(weights, attn_impl), to_torch(batch)
    with torch.no_grad():
        loss, logits = model(t, "ensemble", deterministic=True)
        hidden = model.encode_train(t, "ensemble")
        cls = model.apply_cls(torch.from_numpy(j_hidden))
        twin = model.forward_train_logits(t, "adapter_1")
        twin_parts = model.apply_cls(model.encode_train(t, "adapter_1"))
    assert logits.shape == (6, LA - 1, 96) and hidden.shape == (6, LA, 32)
    for got, want in ((loss, j_loss), (logits, j_logits), (hidden, j_hidden), (cls, j_logits)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert torch.equal(twin, twin_parts)
    # the fused step's task loss (LSE minus the target logit) is the same loss
    fused_loss = trainers.albef_fused_task_loss()(logits, t)
    np.testing.assert_allclose(float(fused_loss), float(j_loss), rtol=RTOL)


def test_momentum_update_matches_jax():
    rng = np.random.RandomState(2)
    p = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    m = {k: rng.randn(*v.shape).astype(np.float32) for k, v in p.items()}
    want = jax_momentum_update(p, m, 0.995)
    got = momentum_update({k: torch.from_numpy(v) for k, v in p.items()},
                          {k: torch.from_numpy(v) for k, v in m.items()})
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)


def _jax_first_step_grads(jmodel, params, batch, opt):
    """JAX's four gradient sets of the first DAT step, its sequence written
    out (``dat.py:225-270``): ② at the initial head, ③ at the head after ②'s
    AdamW update."""
    part = jdat.Partitioner(params, "fed", JaxPEFTMode.DAT)
    forward = jax_make_albef_forward(jmodel)
    tx = joptim.adamw_direction(opt)
    state = jdat.init_train_state(params, part, opt, jax.random.PRNGKey(0))
    lr1 = jdat._make_lr_at(opt, 100)(0, batch)
    key = jax.random.PRNGKey(0)

    def grads(p, b):
        _, logits_all = forward(p, b, "ensemble", key)
        shared, head = part.extract(p, part.shared_paths), part.extract(p, part.head_paths)

        def loss1(s, h):
            task, logits = forward(part.merge_into(part.merge_into(p, s), h), b, "adapter_1", key)
            return (task + jax_kd_kl_loss(logits, logits_all)) / 2.0, logits

        (_, logits_1), (g_shared, g_head2) = jax.value_and_grad(loss1, (0, 1), has_aux=True)(shared, head)
        new_head, _ = joptim.apply_direction(tx, g_head2, state.opt_states["head"], head, lr1)
        local = part.extract(p, part.local_paths)

        def loss0(lo, h):
            task, logits = forward(part.merge_into(part.merge_into(p, lo), h), b, "ensemble", key)
            return (task + jax_kd_kl_loss(logits, logits_1)) / 2.0

        g_local, g_head = jax.grad(loss0, (0, 1))(local, new_head)
        return {"shared": g_shared, "head_2": g_head2, "local": g_local, "head_3": g_head}

    out = jax.jit(grads)(params, batch)
    return {k: albef_from_flax(jax.tree_util.tree_map(np.asarray, v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_albef_runs(weights):
    """JAX's losses and parameters after each of 2 steps of its standard step
    (attn_impl "auto") and its fused step ("flash", the Pallas kernels in
    interpret mode), and its first step's gradient sets ("auto"): with dropout
    off all of them compute one function."""
    batch = _train_batch(3)
    opt = JaxOptimizerConfig(**OPT)
    part = jdat.Partitioner(weights, "fed", JaxPEFTMode.DAT)
    steps = {"standard": jdat.make_dat_train_step(jax_make_albef_forward(JaxAlbef(TINY)), part, opt,
                                                  100, donate=False),
             "fused": jax_make_albef_fused_dat_step(JaxAlbef(TINY, attn_impl="flash"), weights, opt,
                                                    100)[0]}
    out = {}
    for kind, step in steps.items():
        state = jdat.init_train_state(weights, part, opt, jax.random.PRNGKey(0))
        traj = []
        for _ in range(2):
            state, m = step(state, batch)
            traj.append((float(m["loss"]), float(m["loss_shared"]),
                         albef_from_flax(jax.tree_util.tree_map(np.asarray, state.params))))
        out[kind] = traj
    out["grads"] = _jax_first_step_grads(JaxAlbef(TINY), weights, batch, opt)
    return batch, out


def _rel(got, want):
    num = sum(float((got[k].float() - want[k]).pow(2).sum()) for k in want)
    return (num / sum(float(w.pow(2).sum()) for w in want.values())) ** 0.5


def _port_step(model, kind, sd):
    opt = OptimizerConfig(**OPT)
    if kind == "standard":
        part = tdat.Partitioner(sd, "fed", PEFTMode.DAT)
        return tdat.make_dat_train_step(make_albef_forward(model), part, opt, 100), part, opt
    step, part = trainers.make_albef_fused_dat_step(model, sd, opt, 100)
    return step, part, opt


@pytest.mark.parametrize("kind", ["standard", "fused"])
@pytest.mark.parametrize("attn_impl", ["auto", "flash"])
def test_albef_dat_steps_match_jax(weights, jax_albef_runs, attn_impl, kind):
    batch, want = jax_albef_runs
    model = port_model(weights, attn_impl)
    sd = _sd(model)
    step, part, opt = _port_step(model, kind, sd)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
    tbatch = to_device(batch, torch.device("cpu"))
    for i, (loss, loss_shared, jparams) in enumerate(want[kind]):
        state, m = step(state, tbatch)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=2e-5)
        np.testing.assert_allclose(float(m["loss_shared"]), loss_shared, rtol=2e-5)
        for k, v in jparams.items():
            np.testing.assert_allclose(state.params[k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=OPT["lr"] / 50, err_msg=k)
        if i == 0:
            jgrads = want["grads"]
            assert set(m["grads"]) == set(jgrads)
            for name, g in jgrads.items():
                assert set(m["grads"][name]) == set(g), name
                assert _rel(m["grads"][name], g) <= 1e-4, name
    assert state.sched_count == 4
    moved = [k for k in sd if not torch.equal(sd[k], state.params[k])]
    assert moved and all(any(t in k for t in ("adapter_0", "adapter_1", ".cls.")) for k in moved)


def test_fused_step_equals_standard_step(weights):
    """As tests/test_dat_fused.py:112-152 holds JAX's: with dropout off the
    fused step's one ensemble pass gives the standard step's three forwards."""
    model = port_model(weights, "flash")
    sd = _sd(model)
    tbatch = to_device(_train_batch(4), torch.device("cpu"))
    runs = {}
    for kind in ("standard", "fused"):
        step, part, opt = _port_step(model, kind, sd)
        state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
        losses = []
        for _ in range(2):
            state, m = step(state, tbatch)
            losses.append(float(m["loss"]))
        runs[kind] = (losses, state.params)
    np.testing.assert_allclose(runs["fused"][0], runs["standard"][0], rtol=1e-5)
    for k, v in runs["standard"][1].items():
        np.testing.assert_allclose(runs["fused"][1][k].numpy(), v.numpy(), rtol=5e-4, atol=1e-6,
                                   err_msg=k)


def _live_model(weights, attn_impl="flash"):
    model = AlbefModel(port_config(LIVE), attn_impl=attn_impl)
    model.load_state_dict(albef_from_flax(weights), strict=True)
    return model


def test_dropout_masks_keep_fraction_scale_and_fp32_point():
    """``keep_mask`` draws a bool Bernoulli(keep) mask from the generator it is given;
    hidden dropout is ``where(keep, x / (1 - rate), 0)``; attention dropout
    applies ``probs * keep / (1 - rate)`` to the fp32 probabilities, before
    their cast to v's dtype."""
    from feddat_tpu_torch.models.layers import dropout

    rate, n = 0.1, 200_000
    keep = seeding.keep_mask((n,), 1 - rate, "cpu", torch.Generator().manual_seed(0))
    frac = keep.float().mean().item()
    assert abs(frac - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** 0.5
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(1))
    with seeding.dropout_rng(torch.Generator().manual_seed(2)):
        y = dropout(x, rate, deterministic=False)
    mask = seeding.keep_mask(x.shape, 1 - rate, "cpu", torch.Generator().manual_seed(2))
    assert torch.equal(y, torch.where(mask, x / (1 - rate), torch.zeros(())))
    assert dropout(x, rate, deterministic=True) is x

    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 2, 5, 8, generator=g).bfloat16() for _ in range(3))
    got = tattention.xla_attention(q, k, v, None, dropout_rate=rate,
                                   generator=torch.Generator().manual_seed(4))
    probs = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * 8 ** -0.5, dim=-1)
    keep = seeding.keep_mask(probs.shape, 1 - rate, "cpu", torch.Generator().manual_seed(4))
    want = (probs * keep / (1 - rate)).bfloat16() @ v
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(RuntimeError, match="explicit generator"):
        tattention.xla_attention(q, k, v, None, dropout_rate=rate)


def test_step_is_a_function_of_its_state_not_the_global_rng(weights):
    """Dropout live: the same state gives a bitwise equal step whatever
    ``torch.manual_seed`` says; another state seed gives another step; the
    state's generator advances by the same draw every step."""
    model = _live_model(weights)
    sd = _sd(model)
    step, part, opt = _port_step(model, "fused", sd)
    tbatch = to_device(_train_batch(5), torch.device("cpu"))

    def run(state_seed, global_seed):
        torch.manual_seed(global_seed)
        state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(state_seed))
        state, m1 = step(state, tbatch)
        state, m2 = step(state, tbatch)
        return [float(m[k]) for m in (m1, m2) for k in ("loss", "loss_shared")], state

    a, sa = run(7, 0)
    b, sb = run(7, 12345)
    c, _ = run(8, 0)
    assert a == b and all(torch.equal(sa.params[k], sb.params[k]) for k in sd)
    assert all(x != y for x, y in zip(a, c))
    assert torch.equal(sa.rng.get_state(), sb.rng.get_state())


def test_fused_step_stages_share_d0_and_d1_differs(weights):
    """The fused step draws two generators per step (JAX ``split(rng, 3)``):
    d0 drives the one ensemble pass that stages ① and ③ share, d1 the
    adapter_1 pass; the standard step draws three (``split(rng, 4)``), one per
    stage.  Each is fresh every step."""
    model = _live_model(weights)
    sd = _sd(model)
    tbatch = to_device(_train_batch(6), torch.device("cpu"))
    calls = []

    def spy(fn):
        def wrapped(p, batch, mode, gen=None):
            calls.append((mode, gen.initial_seed()))
            return fn(p, batch, mode, gen)
        return wrapped

    encode, head_fn, task_loss = trainers.albef_fused_parts(
        model, {k: v for k, v in sd.items() if ".cls." not in k}, dropout=True)
    part = tdat.Partitioner(sd, "fed", PEFTMode.DAT)
    opt = OptimizerConfig(**OPT)
    fused = tdat.make_dat_train_step_fused(spy(encode), head_fn, task_loss, part, opt, 100)
    standard = tdat.make_dat_train_step(spy(make_albef_forward(model)), part, opt, 100)
    for step, n in ((fused, 2), (standard, 3)):
        calls.clear()
        state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(9))
        state, _ = step(state, tbatch)
        step(state, tbatch)
        modes = [m for m, _ in calls]
        seeds = [s for _, s in calls]
        assert modes == (["ensemble", "adapter_1"] if n == 2 else
                         ["ensemble", "adapter_1", "ensemble"]) * 2
        assert len(set(seeds)) == 2 * n  # distinct within a step and across steps
        nxt, first = seeding.split_rng(torch.Generator().manual_seed(9), n)
        assert seeds == first + seeding.split_rng(nxt, n)[1]


@pytest.mark.parametrize("live", [True, False])
def test_flash_runs_at_the_vit_sites_only_when_dropout_is_live(weights, live, monkeypatch):
    """JAX's routing (attention.py:96-106): a "flash" site with live attention
    dropout takes the composable path with dropout.  ViT has no dropout, so
    with ALBEF's 0.1 live the flash function runs at the ViT's sites alone."""
    model = _live_model(weights) if live else port_model(weights, "flash")
    sd = _sd(model)
    step, part, opt = _port_step(model, "fused", sd)
    counts = {"flash": 0, "xla": 0}
    real_flash, real_xla = tattention.flash_attention, tattention.xla_attention

    def flash(*a, **kw):
        counts["flash"] += 1
        return real_flash(*a, **kw)

    def xla(*a, **kw):
        counts["xla"] += 1
        return real_xla(*a, **kw)

    monkeypatch.setattr(tattention, "flash_attention", flash)
    monkeypatch.setattr(tattention, "xla_attention", xla)
    state = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
    step(state, to_device(_train_batch(7), torch.device("cpu")))
    c = TINY
    text, fusion = c.bert.fusion_layer, c.bert.num_layers - c.bert.fusion_layer
    bert_sites = text + 2 * fusion + 2 * c.decoder_layers
    passes = 2  # the fused step's two encoder passes
    if live:
        assert counts == {"flash": passes * c.vision_layers, "xla": passes * bert_sites}
    else:
        assert counts == {"flash": passes * (c.vision_layers + bert_sites), "xla": 0}


def test_fused_loss_means_match_jax_by_distribution(weights):
    """In the manner of tests/test_dat_fused.py:216-275 (there JAX's fused
    step against its standard step, marked slow): with dropout 0.3 live, the
    port's fused-step losses (two steps, both losses) over N generator seeds
    against JAX's over N keys, from the same weights and batch: both
    stochastic, and each mean within 4 pooled standard errors of the other."""
    cfg = dataclasses.replace(TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.3,
                                                             attention_dropout=0.3))
    batch = _train_batch(8)
    n = 16
    jopt = JaxOptimizerConfig(**OPT)
    jstep, jpart = jax_make_albef_fused_dat_step(JaxAlbef(cfg), weights, jopt, 100)
    model = AlbefModel(port_config(cfg), attn_impl="flash")
    model.load_state_dict(albef_from_flax(weights), strict=True)
    sd = _sd(model)
    step, part, opt = _port_step(model, "fused", sd)
    tbatch = to_device(batch, torch.device("cpu"))
    losses = {"jax": [], "port": []}
    for seed in range(n):
        js = jdat.init_train_state(weights, jpart, jopt, jax.random.PRNGKey(100 + seed))
        ts = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(100 + seed))
        row_j, row_t = [], []
        for _ in range(2):
            js, jm = jstep(js, batch)
            ts, tm = step(ts, tbatch)
            row_j += [float(jm["loss"]), float(jm["loss_shared"])]
            row_t += [float(tm["loss"]), float(tm["loss_shared"])]
        losses["jax"].append(row_j)
        losses["port"].append(row_t)
    j, t = np.array(losses["jax"]), np.array(losses["port"])
    assert j.std(axis=0).min() > 1e-6 and t.std(axis=0).min() > 1e-6
    se = np.sqrt((j.var(axis=0) + t.var(axis=0)) / n)
    diff = np.abs(j.mean(axis=0) - t.mean(axis=0))
    assert (diff < 4 * se + 1e-7).all(), (diff, 4 * se, j.mean(axis=0), t.mean(axis=0))


def test_synthetic_albef_client_twin_is_bitwise_equal():
    a, b = JaxAlbefClient("c", seed=3, **CLIENT), SyntheticAlbefClient("c", seed=3, **CLIENT)
    np.testing.assert_array_equal(a.answer_ids, b.answer_ids)
    np.testing.assert_array_equal(a.answer_mask, b.answer_mask)
    for ja, tb in zip([*a.train_batches(1), *a.eval_batches()], [*b.train_batches(1), *b.eval_batches()]):
        assert ja.keys() == tb.keys()
        for k in ja:
            np.testing.assert_array_equal(ja[k], tb[k])


def _cfg(mod, rounds=1):
    return mod["TrainConfig"](
        encoder_name="albef_no_distill", peft_mode=mod["PEFTMode"].DAT,
        optimizer=mod["OptimizerConfig"](**OPT),
        federated=mod["FederatedConfig"](comm_rounds=rounds, local_epochs=1, eval_every=1),
        num_epochs=1, seed=0)


PORT_CFG = dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
                FederatedConfig=FederatedConfig)


def _shared_steps(make):
    """``make`` memoised on what fixes the step's function: the model, the
    optimizer, the horizon, the partitions and the dropout generator."""
    made = {}

    def shared(model, params, opt_cfg, max_steps, part=None, **kw):
        key = (id(model), opt_cfg, max_steps, kw.get("dropout_rng"), kw.get("donate"),
               None if part is None else (part.shared_paths, part.local_paths, part.head_paths))
        if key not in made:
            made[key] = make(model, params, opt_cfg, max_steps, part=part, **kw)
        return made[key]

    return shared


def test_federated_round_matches_jax_engine(weights):
    """Two clients, one round of 2 fused steps each (dropout off), FedAvg of
    adapter_1, and evaluate_dat by rank_answer (k=4): the port with "flash"
    against the JAX engine with "auto" (one function), the server parameters
    and the three-mode scores."""
    jclients = {f"c{i}": JaxAlbefClient(f"c{i}", seed=i, **CLIENT) for i in range(2)}
    jcfg = _cfg(dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode,
                     OptimizerConfig=JaxOptimizerConfig, FederatedConfig=JaxFederatedConfig))
    jmodel = JaxAlbef(TINY)
    # every client's bank is the same (it depends on num_answers alone): one eval step
    bank = (jclients["c0"].answer_ids, jclients["c0"].answer_mask)
    assert all(np.array_equal(c.answer_ids, bank[0]) for c in jclients.values())
    jeval = jax_make_albef_eval_step(jmodel, *bank, k=4)
    with pytest.MonkeyPatch.context() as mp:
        # the clients' fused steps compute one function (ALBEF's one cls head,
        # the same optimizer and horizon), as the port's clients share one
        # program: one JAX compile for both
        mp.setattr(jtrainers, "make_albef_fused_dat_step", _shared_steps(jtrainers.make_albef_fused_dat_step))
        jt = JaxTrainer(jmodel, weights, jclients, jcfg, use_fused_dat=True,
                        make_forward=lambda m, k: jax_make_albef_forward(m),
                        make_eval=lambda m, k: jeval)
        assert jt.clients[0].train_step is jt.clients[1].train_step
    jt.run()

    clients = {f"c{i}": SyntheticAlbefClient(f"c{i}", seed=i, **CLIENT) for i in range(2)}
    hooks = trainers.resolve_trainer("albef_no_distill", "vqa", rank_k=4, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    tt = FederatedTrainer(port_model(weights, "flash"), None, clients, _cfg(PORT_CFG),
                          make_forward=hooks.make_forward, make_eval=hooks.make_eval,
                          use_fused_dat=True, device="cpu")
    tt.run()
    want = albef_from_flax(jax.tree_util.tree_map(np.asarray, jt.server_params))
    init = albef_from_flax(weights)
    assert set(want) == set(tt.server_params)
    moved = 0
    for k, v in want.items():
        np.testing.assert_allclose(tt.server_params[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=OPT["lr"] / 50, err_msg=k)
        moved += "adapter_1" in k and not torch.equal(v, init[k])
    assert moved == 4 * (TINY.vision_layers + TINY.bert.num_layers + TINY.decoder_layers)
    (je,), (te,) = jt.history, tt.history
    for key in clients:
        assert len(te["scores"][key]) == 3
        np.testing.assert_allclose(te["scores"][key], je["scores"][key], rtol=0, atol=1e-9)


def test_live_dropout_round_logs_the_fused_deviation(weights, caplog):
    """With ALBEF's 0.1 live the engine's fused ALBEF step threads the masks
    through and logs its one deviation at INFO (stages ① and ③ share the
    ensemble pass's masks), as the JAX engine does."""
    clients = {f"c{i}": SyntheticAlbefClient(f"c{i}", seed=i, **CLIENT) for i in range(2)}
    hooks = trainers.resolve_trainer("albef_no_distill", "vqa", rank_k=4, answer_banks={
        k: (c.answer_ids, c.answer_mask) for k, c in clients.items()})
    with caplog.at_level(logging.INFO, logger="feddat_tpu_torch"):
        trainer = FederatedTrainer(_live_model(weights), None, clients, _cfg(PORT_CFG),
                                   make_forward=hooks.make_forward, make_eval=hooks.make_eval,
                                   use_fused_dat=True, device="cpu")
    assert any("carries live dropout" in r.message for r in caplog.records)
    history = trainer.run()
    assert history and all(len(v) == 3 for v in history[-1]["scores"].values())


def test_trainer_hooks_and_refusals():
    """``resolve_trainer`` routes like JAX's (``albef_distill`` to the
    distillation hooks); an unknown dropout generator raises, and so does the
    distill forward in the standard DAT step, at its first step, with JAX's
    TypeError (the step does not pass the twin)."""
    hooks = trainers.resolve_trainer("albef_no_distill", "vqa", answer_banks={})
    assert hooks.make_eval is not None and hooks.metric == "vqa_score"
    assert not hooks.aux_forward and hooks.aux_init is None and hooks.batch_transform is None
    assert trainers.resolve_trainer("vilt", "nlvr2").metric == "accuracy"
    distill = trainers.resolve_trainer("albef_distill", "vqa", answer_banks={})
    assert distill.aux_forward and distill.aux_init is not None and distill.batch_transform is not None
    with pytest.raises(ValueError, match="answer_banks"):
        trainers.resolve_trainer("albef_no_distill", "vqa")
    assert trainers.model_dropout_rate(AlbefModel(port_config(LIVE))) == 0.1
    assert trainers.model_dropout_rate(AlbefModel(port_config(TINY))) == 0.0
    clients = {"c0": SyntheticAlbefClient("c0", **CLIENT)}
    hooks = trainers.resolve_trainer("albef_no_distill", "vqa", rank_k=4, answer_banks={
        "c0": (clients["c0"].answer_ids, clients["c0"].answer_mask)})
    for impl in ("threefry", "rbg", "philox"):  # "rbg", the TPU's hardware RNG, gives the same generators
        cfg = dataclasses.replace(_cfg(PORT_CFG), dropout_rng=impl)
        with pytest.raises(ValueError, match="dropout_rng") if impl == "philox" else contextlib.nullcontext():
            FederatedTrainer(AlbefModel(port_config(TINY)), None, clients, cfg,
                             make_forward=hooks.make_forward, make_eval=hooks.make_eval, device="cpu")
    distill = trainers.resolve_trainer("albef_distill", "vqa", rank_k=4, answer_banks={
        "c0": (clients["c0"].answer_ids, clients["c0"].answer_mask)})
    trainer = FederatedTrainer(AlbefModel(port_config(TINY)), None, clients, _cfg(PORT_CFG),
                               make_forward=distill.make_forward, make_eval=distill.make_eval,
                               aux_init=distill.aux_init, batch_transform=distill.batch_transform,
                               aux_forward=distill.aux_forward, device="cpu")
    with pytest.raises(TypeError, match="missing 1 required positional argument: 'aux'"):
        trainer.run()
