"""The port's data-parallel steps and SNR-parallel sweeps (`parallel/`) on
the CPU over gloo: one module fixture spawns a 2-rank group once and runs
every case there (`torch_parallel_worker.rank_main`); the single-process
references run in this process, the JAX sides on the conftest's virtual
CPU devices.

- dp = 2 against the single-process step (plain, FGM at adv_weight 0.5,
  GAN, MINE, star; bs 8, dropout on, every draw from one seed): the
  losses within rtol 1e-5 (MINE's MI 1e-4, as tests/test_sharding.py holds
  JAX's), the averaged gradients within 1e-5 of their largest, the params
  (and T's) within atol 1e-5 wherever Adam's update is not decided by a
  rounding-level gradient (`torch_parallel_worker.TINY_GRAD`; such elements
  are held to be under 1 % of the model);
- on a batch whose halves are at very different scales, the same; and
  with the power norm, the FGM norm or MINE's bound made rank-local in a
  copy of the code, a mismatch;
- dp = 2 against the JAX package's dp step (plain, FGM) on JAX's draws;
- the greedy, KV and beam sweeps over 4 SNR points split over 2 ranks:
  ids equal to the single-process sweeps' and to the JAX sharded sweeps';
  the teacher-forced sweep's ce and acc within 1e-5 of JAX's;
- `cli train --distributed --dp 2` against `cli train` at bs 8, and `cli
  evaluate --distributed --snr-parallel 2` against the single run;
- the CLI's refusals, which spawn nothing.
"""

import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from deepsc_gan_tpu.parallel.mesh import local_mesh, make_mesh
from deepsc_gan_tpu.parallel.sharding import (
    make_parallel_attack_step as jax_par_attack,
    make_parallel_beam_sweep as jax_par_beam,
    make_parallel_greedy_kv_sweep as jax_par_kv,
    make_parallel_greedy_sweep as jax_par_greedy,
    make_parallel_snr_sweep as jax_par_snr,
    make_parallel_train_step as jax_par_train,
    replicate,
    shard_batch,
)
from deepsc_gan_tpu.train import steps as jsteps
from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.parallel import mesh as pmesh
from deepsc_gan_tpu_torch.parallel.launch import run_ranks
from deepsc_gan_tpu_torch.utils import convert
from test_torch_greedy import TINY_FLAGS
from test_torch_model import flax_params, port_config

STEP_CASES = ("plain", "attack", "gan", "mine", "star")
# a statistic made rank-local, and the step that reads it
LOCAL = {"power": "plain", "fgm": "attack", "mine": "mine"}
JAX_CASES = ("plain", "attack")
SNRS = (0.0, 4.0, 8.0, 12.0)
BEAM = 3
RTOL = ATOL = worker.TOL


def _batches(cfg, n, seed):
    return [worker.scaled_batch(cfg, seed + i) for i in range(n)]


def _state_dict(cfg, params, variant="transformer"):
    model = convert.load_into(make_model(cfg, variant), params)
    return {n: t.numpy().copy() for n, t in model.state_dict().items()}


def _jax_inputs(jcfg, tcfg, batches):
    """The JAX dp cases' inputs: -> {case: (the port's run_case kwargs,
    with the flax params and JAX's draws; what `_jax_steps` needs)}."""
    out = {}
    shape = (jcfg.bs, jcfg.seq_len, jcfg.channel_dim)
    for case in JAX_CASES:
        jmodel, params = flax_params(jcfg, seed=4)
        draws = []
        for i in range(len(batches)):
            key = jax.random.PRNGKey(100 + i)
            keys = ((jax.random.split(key, 3)[0],) if case == "plain"
                    else jax.random.split(key, 4)[:2])
            draws.append(tuple(np.asarray(jax.random.normal(
                k, shape, jnp.float32)) for k in keys))
        kw = dict(case=case, seed=0, batches=batches,
                  params=_state_dict(tcfg, params), draws=draws)
        out[case] = (kw, (jmodel, params))
    return out


def _jax_steps(jcfg, batches, jmodel, params, case):
    """JAX's dp steps (local_mesh(2)) from `params`: -> (losses,
    params)."""
    jstate = jsteps.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(params=params, opt_state=jstate.tx.init(params))
    mesh = local_mesh(2)
    if case == "plain":
        par = jax_par_train(jmodel, jcfg, mesh)
    else:
        par = jax_par_attack(jmodel, jcfg, mesh,
                             adv_weight=worker.ADV_WEIGHT)
    state = replicate(jstate, mesh)
    losses = []
    for i, inp in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        b = shard_batch(jnp.asarray(inp, jnp.int32), mesh)
        if case == "plain":
            state, loss = par(state, b, b, replicate(key, mesh),
                              replicate(jnp.asarray(worker.N_STD), mesh))
            losses.append(float(loss))
        else:
            state, (c, a) = par(state, b, b, key, worker.PNR_DB,
                                worker.N_STD, 1.0)
            losses.append((float(c), float(a)))
    return losses, state.params


def _sweep_inputs(jcfg, tcfg, inp):
    jmodel, params = flax_params(jcfg, seed=2)
    key = jax.random.PRNGKey(6)
    n_stds = np.asarray([1.0 / np.sqrt(10.0 ** (s / 10.0)) for s in SNRS],
                        np.float32)
    shape = (inp.shape[0], jcfg.seq_len, jcfg.channel_dim)
    noise = np.stack([np.asarray(jax.random.normal(k, shape, jnp.float32))
                      for k in jax.random.split(key, len(SNRS))])
    return (jmodel, params, key, n_stds,
            dict(params=_state_dict(tcfg, params), inp=np.asarray(inp),
                 n_stds=n_stds, noise=noise, beam_size=BEAM))


def _cli_argv(tmp, extra):
    return (["--device", "cpu", *TINY_FLAGS, "--checkpoint-path",
             str(tmp / "ckpt"), "--log-save-path", str(tmp / "log"),
             "--test-save-path", str(tmp / "none.pkl"),
             "--train-save-path", str(tmp.parent / "train.pkl")] + extra)


TRAIN = ["--bs", "8", "--epochs", "1", "--scan-steps", "1",
         "--log-every", "1000"]
EVAL = ["--bs", "4", "--eval-batches", "1", "--snr-lo", "0", "--snr-hi",
        "3", "--kv-cache"]


def _sweeps_of_jax(jcfg, jmodel, params, key, n_stds, inp):
    """JAX's sharded sweeps over make_mesh(dp=1, snr=2)."""
    mesh = make_mesh(dp=1, snr=2)
    inp = jnp.asarray(inp, jnp.int32)
    s = jnp.asarray(n_stds)
    out = {"greedy": jax_par_greedy(jmodel, jcfg, mesh)(params, inp, key,
                                                        0.0, s),
           "kv": jax_par_kv(jmodel, jcfg, mesh)(params, inp, key, 0.0, s),
           "beam": jax_par_beam(jmodel, jcfg, mesh, beam_size=BEAM)(
               params, inp, key, jnp.asarray(0.0), s)}
    out = {k: np.asarray(v) for k, v in out.items()}
    out["ce"], out["acc"] = (np.asarray(x) for x in jax_par_snr(
        jmodel, jcfg, mesh)(params, inp, inp, key, s))
    return out


@pytest.fixture(scope="module")
def group(tiny_cfg, tiny_batch, tmp_path_factory):
    """Everything the 2-rank group computed, and what the tests compare it
    with. The ranks, JAX's dp steps and JAX's sweeps run in threads of
    their own beside the single-process CLI runs."""
    torch.set_num_threads(1)
    jcfg = tiny_cfg.replace(bs=8)
    cfg = port_config(jcfg)
    jax_cfg0 = jcfg.replace(encoder_dropout=0.0, decoder_dropout=0.0)
    cfg0 = port_config(jax_cfg0)
    tmp = tmp_path_factory.mktemp("parallel")
    with open(tmp / "train.pkl", "wb") as f:   # 4 steps at bs 8
        pickle.dump([list(row[row > 0]) for row in
                     worker.scaled_batch(cfg.replace(bs=32), 40)], f)
    spec = {"device": "cpu", "cfg": cfg, "steps": {}, "jax": {}, "cli": {},
            "jax_cfg": cfg0, "sweep_cfg": port_config(tiny_cfg)}
    for case in STEP_CASES:
        n = 1 if case == "mine" else 2
        spec["steps"][case] = dict(case=case, seed=1,
                                   batches=_batches(cfg, n, 10))
        spec["steps"][case + "_scaled"] = dict(
            case=case, seed=1, batches=_batches(cfg, 1, 20), scale=True)
    for stat, case in LOCAL.items():
        spec["steps"][f"{case}_local_{stat}"] = dict(
            case=case, seed=1, batches=_batches(cfg, 1, 20), scale=True,
            local=stat)
    jax_batches = _batches(cfg0, 2, 30)
    jax_inputs = _jax_inputs(jax_cfg0, cfg0, jax_batches)
    for case, (kw, _) in jax_inputs.items():
        spec["jax"][case] = kw
    sweep = _sweep_inputs(tiny_cfg, port_config(tiny_cfg), tiny_batch)
    spec["sweeps"] = sweep[-1]
    spec["cli"]["train"] = ["train", "--distributed", "--dp", "2"] \
        + _cli_argv(tmp / "dp", TRAIN)
    spec["cli"]["evaluate"] = ["evaluate", "--distributed", "--snr-parallel",
                               "2"] + _cli_argv(tmp / "snr", EVAL)
    jobs = {
        "ranks": lambda: run_ranks(worker.rank_main, 2, spec),
        "jax_runs": lambda: {
            case: _jax_steps(jax_cfg0, jax_batches, *extra, case)
            for case, (_, extra) in jax_inputs.items()},
        "jax_sweeps": lambda: _sweeps_of_jax(tiny_cfg, *sweep[:4],
                                             sweep[-1]["inp"]),
    }
    done = {}

    def run(name):
        try:
            done[name] = jobs[name]()
        except BaseException as e:  # re-raised below, in the test
            done[name] = e

    threads = [threading.Thread(target=run, args=(name,)) for name in jobs]
    for t in threads:
        t.start()
    try:
        single = {"train": cli.main(["train"]
                                    + _cli_argv(tmp / "one", TRAIN)),
                  "evaluate": cli.main(["evaluate"]
                                       + _cli_argv(tmp / "one_eval", EVAL)),
                  "sweeps": worker.run_sweeps(spec["sweep_cfg"],
                                              **sweep[-1])}
    finally:
        for t in threads:
            t.join()
    for value in done.values():
        if isinstance(value, BaseException):
            raise value
    return dict(spec=spec, ranks=done["ranks"], cfg=cfg,
                jax_runs=done["jax_runs"], jax_sweeps=done["jax_sweeps"],
                jcfg=tiny_cfg, single=single, tmp=tmp)


def _reference(group, key):
    kw = dict(group["spec"]["steps"][key])
    kw.pop("local", None)
    return worker.run_case(cfg=group["cfg"], **kw)


def _mi_column(key):
    return 1 if key.startswith("mine") else None


def test_group_ran_on_gloo_with_two_ranks(group):
    for r, out in enumerate(group["ranks"]):
        assert out["backend"] == "gloo" and out["world"] == 2, r


@pytest.mark.parametrize("key", [c for c in STEP_CASES]
                         + [c + "_scaled" for c in STEP_CASES])
def test_dp_step_matches_the_single_process_step(group, key):
    ref = _reference(group, key)
    for r, got in enumerate(group["ranks"]):
        worker.assert_close_to(ref, got["steps"][key], f"{key} rank {r}",
                         _mi_column(key))


@pytest.mark.parametrize("key", STEP_CASES)
def test_every_rank_ends_the_step_with_the_same_state(group, key):
    a, b = (out["steps"][key] for out in group["ranks"])
    for tree in ("params", "mine"):
        for name in (a[tree] or {}):
            np.testing.assert_array_equal(a[tree][name], b[tree][name],
                                          err_msg=f"{key}: {name}")


@pytest.mark.parametrize("stat", list(LOCAL))
def test_a_rank_local_statistic_fails_on_scaled_halves(group, stat):
    """The scaled-halves batch has teeth: with the statistic computed over
    the rank's rows alone, the run no longer matches the single step."""
    key = f"{LOCAL[stat]}_local_{stat}"
    ref = _reference(group, key)
    with pytest.raises(AssertionError):
        worker.assert_close_to(ref, group["ranks"][0]["steps"][key], key,
                         _mi_column(key))


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", JAX_CASES)
def test_dp_step_matches_the_jax_dp_step(group, case):
    want_losses, want_params = group["jax_runs"][case]
    cfg0 = group["spec"]["jax_cfg"]
    for r, out in enumerate(group["ranks"]):
        got = out["jax"][case]
        np.testing.assert_allclose(worker.flat_losses(got["losses"]),
                                   worker.flat_losses(want_losses), rtol=RTOL,
                                   err_msg=f"{case} rank {r}")
        named = {n: torch.from_numpy(a) for n, a in got["params"].items()}
        got_tree = _leaves(convert.state_dict_to_flax(named, cfg0))
        tiny = _leaves(convert.state_dict_to_flax(
            {n: torch.from_numpy(np.broadcast_to(
                np.asarray(got["tiny"].get(n, False)), a.shape).copy())
             for n, a in got["params"].items()}, cfg0))
        for name, want in _leaves(want_params).items():
            keep = ~tiny[name].astype(bool)
            np.testing.assert_allclose(got_tree[name][keep], want[keep],
                                       rtol=0, atol=ATOL,
                                       err_msg=f"{case} rank {r}: {name}")


def test_dp_step_launches_no_kernel_on_the_cpu(group):
    for out in group["ranks"]:
        for key, run in out["steps"].items():
            assert not any(run["counts"].values()), (key, run["counts"])


@pytest.fixture(scope="module")
def sweeps(group):
    """(the single-process sweeps, JAX's sharded sweeps)."""
    return group["single"]["sweeps"], group["jax_sweeps"]


@pytest.mark.parametrize("name", worker.SWEEPS)
def test_snr_parallel_sweep_ids_equal_the_single_and_jax_sweeps(group,
                                                                sweeps,
                                                                name):
    single, jax_out = sweeps
    assert single[name].shape == (len(SNRS), 4, group["jcfg"].max_length
                                  + 1)
    np.testing.assert_array_equal(single[name], jax_out[name])
    for out in group["ranks"]:
        np.testing.assert_array_equal(out["sweeps"][name], single[name])


def test_snr_parallel_teacher_forced_sweep_matches_jax(group, sweeps):
    single, jax_out = sweeps
    for out in group["ranks"]:
        for key in ("ce", "acc"):
            np.testing.assert_allclose(out["sweeps"][key], jax_out[key],
                                       rtol=RTOL, atol=RTOL, err_msg=key)
            np.testing.assert_allclose(out["sweeps"][key], single[key],
                                       rtol=RTOL, atol=RTOL, err_msg=key)


def test_cli_train_dp_matches_the_single_process_cli(group):
    want = group["single"]["train"]["losses"].numpy()
    for out in group["ranks"]:
        np.testing.assert_allclose(out["cli"]["train"]["losses"], want,
                                   rtol=RTOL)
    log = group["tmp"] / "dp" / "log" / "train.jsonl"
    assert log.exists() and (group["tmp"] / "dp" / "ckpt"
                             / "transformer_params.pkl").exists()


def test_cli_evaluate_snr_parallel_matches_the_single_process_cli(group):
    want = group["single"]["evaluate"]["table"]
    for out in group["ranks"]:
        np.testing.assert_allclose(out["cli"]["evaluate"]["table"], want,
                                   rtol=1e-12)


@pytest.mark.parametrize("argv,message", [
    (["evaluate", "--snr-parallel", "3", "--snr-lo", "0", "--snr-hi", "3"],
     "must divide the number of SNR points"),
    (["evaluate", "--snr-parallel", "2", "--eval-mode", "beam",
      "--beam-impl", "full", "--snr-lo", "0", "--snr-hi", "3"],
     "--beam-impl kv"),
    (["train", "--dp", "3", "--bs", "4"], "not divisible by --dp 3"),
    (["train", "--dp", "2", "--bs", "4"], "there is no process group"),
    (["evaluate", "--snr-parallel", "2", "--snr-lo", "0", "--snr-hi", "3"],
     "torchrun"),
    (["train", "--tp", "2"], "ROADMAP §A.2.2"),
    (["train", "--pp", "2"], "ROADMAP §A.2.3"),
])
def test_cli_refuses_what_the_group_cannot_run(tmp_path, argv, message):
    with pytest.raises(SystemExit, match=message.replace(".", r"\.")):
        cli.main(argv[:1] + _cli_argv(tmp_path, argv[1:]))
    assert not pmesh.world_size() > 1


def test_backend_rule(monkeypatch):
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert pmesh.choose_backend("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pmesh.choose_backend("cuda") == "gloo"   # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.choose_backend("cuda") == "nccl"


def test_a_single_process_stays_local(monkeypatch):
    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert pmesh.initialize_distributed("cpu") is None
    mesh = pmesh.make_mesh()
    assert mesh.shape == {"snr": 1, "dp": 1} and mesh.dp_group is None


def test_config_has_the_jax_parallel_fields(tiny_cfg):
    from deepsc_gan_tpu_torch.utils.config import Config

    names = {f.name: f.default for f in dataclasses.fields(Config)}
    for name in ("dp", "tp", "pp", "pp_microbatches"):
        assert names[name] == getattr(type(tiny_cfg)(), name), name
