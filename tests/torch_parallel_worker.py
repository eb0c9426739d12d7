"""The rank side of tests/test_torch_parallel.py: the port's train steps
and sweeps, single-process or data-/SNR-parallel, at a small size. It
imports torch and the port alone, so a spawned rank does not import JAX;
the test process runs the same functions for its single-process
references (`mesh=None`)."""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from deepsc_gan_tpu_torch import cli
from deepsc_gan_tpu_torch.models import channel as channel_module
from deepsc_gan_tpu_torch.models import gan as gan_module
from deepsc_gan_tpu_torch.models import mine as mine_module
from deepsc_gan_tpu_torch.models.transceiver import make_model
from deepsc_gan_tpu_torch.ops import attention_kernel as attn
from deepsc_gan_tpu_torch.ops import ce_kernel as ce
from deepsc_gan_tpu_torch.ops import star_kernel as star
from deepsc_gan_tpu_torch.ops import topk_kernel as topk
from deepsc_gan_tpu_torch.parallel import mesh as pmesh
from deepsc_gan_tpu_torch.parallel import sharding
from deepsc_gan_tpu_torch.train import gan_steps, mine_steps, steps
from deepsc_gan_tpu_torch.utils.config import Config

N_STD = 0.3
PNR_DB = 0.0
ADV_WEIGHT = 0.5
# the variant each step case trains
VARIANT = {"plain": "transformer", "attack": "transformer",
           "gan": "gan", "mine": "transformer", "star": "star"}
# the tolerance of tests/test_sharding.py's dp tests: losses (rtol),
# params (atol), gradients (atol over their largest)
TOL = 1e-5
# the rows of a scaled-halves batch take their words from disjoint ranges:
# the first half's embedding rows are scaled
SCALE = 10.0


def split_words(vocab: int):
    """The word ids of the first and of the second half of a
    scaled-halves batch."""
    mid = (6 + vocab) // 2
    return (6, mid), (mid, vocab)


def scaled_batch(cfg: Config, seed: int) -> np.ndarray:
    """(bs, seq_len) sentences, the first half's words from the lower
    range and the second half's from the upper (`split_words`)."""
    rng = np.random.default_rng(seed)
    lo, hi = split_words(cfg.vocab_size)
    out = np.zeros((cfg.bs, cfg.seq_len), np.int64)
    for i in range(cfg.bs):
        a, b = lo if i < cfg.bs // 2 else hi
        length = int(rng.integers(5, cfg.seq_len + 1))
        out[i, 0] = cfg.start_idx
        out[i, 1:length - 1] = rng.integers(a, b, size=length - 2)
        out[i, length - 1] = cfg.end_idx
    return out


@contextlib.contextmanager
def rank_local(statistic):
    """The block with one batch-wide statistic computed over the rank's
    rows alone (its dp group dropped): "power" (the power normalizations),
    "fgm" (the FGM's global norm) or "mine" (MINE's bound). A copy of the
    code with the group flipped off, which the tests expect to fail."""
    if statistic is None:
        yield
        return
    patches = []
    if statistic == "power":
        orig = channel_module.power_normalize
        local = (lambda x, half=False, group=None: orig(x, half))
        patches = [(channel_module, "power_normalize", local),
                   (gan_module, "power_normalize", local)]
    elif statistic == "fgm":
        orig = steps.fgm_normalize
        patches = [(steps, "fgm_normalize",
                    lambda g, epsilon=1.0, group=None: orig(g, epsilon))]
    elif statistic == "mine":
        orig = mine_module.mutual_information
        patches = [(mine_module, "mutual_information",
                    lambda tj, tm, group=None: orig(tj, tm))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, fn in patches:
        setattr(m, name, fn)
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def launch_counts() -> dict:
    return {"K1": attn.launches, "K2": attn.bwd_launches,
            "K3": ce.fwd_launches, "K4": ce.bwd_launches,
            "K5": star.launches, "K6": topk.launches}


def reset_counts() -> None:
    for module in (attn, ce, star, topk):
        module.reset_launches()


def _host(named) -> dict:
    return {n: t.detach().float().cpu().numpy().copy() for n, t in named}


# An Adam update of an element whose gradient is this small is decided by
# rounding: g / (|g| + 1e-8) swings with the last bits of g, so a sum
# taken in another order (two half-batches) moves the element by up to
# 2 lr; `tiny` marks them
TINY_GRAD = 1e-6


def _recorder(prefix, module, grads, tiny):
    """An optimizer pre-step hook recording `module`'s gradients (the last
    update's in `grads`; in `tiny`, the elements whose gradient was
    nonzero and below TINY_GRAD at any update)."""

    def hook(opt, args, kwargs):
        for name, p in module.named_parameters():
            if p.grad is None:
                continue
            g = p.grad.detach().float().cpu().numpy().copy()
            grads[prefix + name] = g
            small = (np.abs(g) > 0) & (np.abs(g) < TINY_GRAD)
            tiny[prefix + name] = tiny.get(prefix + name, False) | small

    return hook


def run_case(case: str, cfg: Config, seed: int, batches, device="cpu",
             mesh=None, params=None, draws=None, local=None,
             scale=False) -> dict:
    """`case` ("plain", "attack" at ADV_WEIGHT and PNR_DB, "gan", "mine",
    "star") for len(batches) steps from a random init (`seed`), or from
    `params` (name -> array); single-process (`mesh` None) or over the
    mesh's dp axis, each batch global. `draws`, one per step: the channel
    noise as the step takes it (plain: noise; attack: (noise1, noise2));
    else the draws come from a generator seeded with `seed`. `scale`: the
    first half's word rows of the encoder's embedding times SCALE. `local`:
    a statistic made rank-local (`rank_local`). -> {"losses" (per step, a
    tuple for attack, gan and mine), "params", "mine" (T's), "grads" (the
    last update's of each optimizer, T's named "T.*"), "tiny" (see
    TINY_GRAD), "counts"}."""
    variant = VARIANT[case]
    model = make_model(cfg, variant)
    if params is None:
        steps.init_params(model, seed)
    else:
        model.load_state_dict({n: torch.from_numpy(np.asarray(a))
                               for n, a in params.items()})
    if scale:
        (a, b), _ = split_words(cfg.vocab_size)
        with torch.no_grad():
            model.semantic_encoder.embed.embedding.weight[a:b] *= SCALE
    model = model.to(device).train()
    if mesh is not None:
        sharding.replicate(model, mesh)
    state = steps.create_train_state(model, cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    mine = mine_state = None
    full = variant == "star"
    if case == "mine":
        mine, mine_state = mine_steps.create_mine_state(cfg, seed,
                                                        device=device)
        if mesh is not None:
            sharding.replicate(mine, mesh)
    if mesh is None:
        make = {"plain": lambda: steps.make_train_step(model, cfg),
                "star": lambda: steps.make_train_step(model, cfg,
                                                      full_target=True),
                "attack": lambda: steps.make_train_attack_step(
                    model, cfg, adv_weight=ADV_WEIGHT),
                "gan": lambda: gan_steps.make_gan_train_step(model, cfg),
                "mine": lambda: mine_steps.make_mine_train_step(
                    model, mine, cfg)}[case]
    else:
        make = {"plain": lambda: sharding.make_parallel_train_step(
                    model, cfg, mesh),
                "star": lambda: sharding.make_parallel_train_step(
                    model, cfg, mesh, full_target=full),
                "attack": lambda: sharding.make_parallel_attack_step(
                    model, cfg, mesh, adv_weight=ADV_WEIGHT),
                "gan": lambda: sharding.make_parallel_gan_step(
                    model, cfg, mesh),
                "mine": lambda: sharding.make_parallel_mine_step(
                    model, mine, cfg, mesh)}[case]
    step = make()
    # every update's gradients (after the group's average), by optimizer
    grads, tiny = {}, {}
    watched = [("", state.optimizer, model)]
    if mine is not None:
        watched.append(("T.", mine_state.optimizer, mine))
    for prefix, opt, module in watched:
        opt.register_step_pre_hook(_recorder(prefix, module, grads, tiny))
    losses = []
    reset_counts()
    with rank_local(local):
        for i, batch in enumerate(batches):
            inp = torch.as_tensor(np.asarray(batch), dtype=torch.long,
                                  device=device)
            d = None if draws is None else [
                torch.as_tensor(np.asarray(x), device=device)
                for x in draws[i]]
            if case in ("plain", "star"):
                state, loss = step(state, inp, inp, gen, N_STD,
                                   *(d or ()))
                losses.append(float(loss))
            elif case == "attack":
                state, out = step(state, inp, inp, gen, PNR_DB, N_STD, 1.0,
                                  *(d or ()))
                losses.append(tuple(float(x) for x in out))
            elif case == "gan":
                state, out = step(state, inp, inp, gen, N_STD)
                losses.append(tuple(float(x) for x in out))
            else:
                state, mine_state, out = step(state, mine_state, inp, inp,
                                              gen, N_STD)
                losses.append(tuple(float(x) for x in out))
    if device != "cpu":
        torch.cuda.synchronize()
    return {"losses": losses, "params": _host(model.named_parameters()),
            "mine": None if mine is None else _host(mine.named_parameters()),
            "grads": grads, "tiny": tiny,
            "counts": launch_counts()}


def flat_losses(losses):
    return np.asarray(losses, np.float64).reshape(len(losses), -1)


def assert_close_to(ref, got, what, mi_column=None, tol=TOL):
    """A parallel run (`run_case`'s result) against a single-process one:
    the losses within rtol `tol` (the MI column, `mi_column`, 10 tol), the
    last update's gradients within `tol` of their largest, the params (and
    T's) within atol `tol` but for the elements TINY_GRAD marks on either
    side, which must be under 1 % of them."""
    lr, lg = flat_losses(ref["losses"]), flat_losses(got["losses"])
    rtol = np.full(lr.shape[1], tol)
    if mi_column is not None:
        rtol[mi_column] = 10 * tol
    for j in range(lr.shape[1]):
        np.testing.assert_allclose(lg[:, j], lr[:, j], rtol=rtol[j],
                                   err_msg=f"{what}: loss column {j}")
    assert sorted(got["grads"]) == sorted(ref["grads"]), what
    scale = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for name, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][name], g, rtol=0,
                                   atol=tol * scale,
                                   err_msg=f"{what}: gradient {name}")
    masked = total = 0
    for tree, prefix in (("params", ""), ("mine", "T.")):
        if ref[tree] is None:
            continue
        for name, want in ref[tree].items():
            tiny = (np.asarray(ref["tiny"].get(prefix + name, False))
                    | np.asarray(got["tiny"].get(prefix + name, False)))
            keep = ~np.broadcast_to(tiny, want.shape)
            masked += int(want.size - keep.sum())
            total += want.size
            np.testing.assert_allclose(
                got[tree][name][keep], want[keep], rtol=0, atol=tol,
                err_msg=f"{what}: {prefix}{name}")
    assert masked <= 0.01 * total, (what, masked, total)


SWEEPS = ("greedy", "kv", "beam")


def run_sweeps(cfg: Config, params, inp, n_stds, noise, device="cpu",
               mesh=None, beam_size=3) -> dict:
    """The greedy, KV and beam sweeps' ids (S, B, max_length+1) and the
    teacher-forced sweep's (ce, acc) over the noise levels `n_stds` with
    the channel noise `noise` (S, B, L, C), the weights `params` (name ->
    array) in eval mode; single-process or split over the mesh's snr axis.
    -> {name: array, "counts": {sweep: launches}}."""
    model = make_model(cfg).to(device)
    model.load_state_dict({n: torch.from_numpy(np.asarray(a))
                           for n, a in params.items()})
    model.eval()
    t = {"inp": torch.as_tensor(np.asarray(inp), dtype=torch.long,
                                device=device),
         "n_stds": torch.as_tensor(np.asarray(n_stds), device=device),
         "noise": torch.as_tensor(np.asarray(noise), device=device)}
    if mesh is None:
        sweeps = {"greedy": sharding.make_greedy_decode_sweep(model, cfg),
                  "kv": sharding.make_greedy_decode_kv_sweep(model, cfg),
                  "beam": sharding.make_beam_decode_sweep(model, cfg,
                                                          beam_size)}
        tf = sharding.make_snr_sweep(model, cfg)
    else:
        sweeps = {"greedy": sharding.make_parallel_greedy_sweep(
                      model, cfg, mesh),
                  "kv": sharding.make_parallel_greedy_kv_sweep(
                      model, cfg, mesh),
                  "beam": sharding.make_parallel_beam_sweep(
                      model, cfg, mesh, beam_size)}
        tf = sharding.make_parallel_snr_sweep(model, cfg, mesh)
    out, counts = {}, {}
    for name, sweep in sweeps.items():
        reset_counts()
        out[name] = sweep(t["inp"], 0.0, t["n_stds"],
                          t["noise"]).cpu().numpy()
        counts[name] = launch_counts()
    ce_, acc = tf(t["inp"], t["inp"], t["n_stds"], t["noise"])
    out["ce"], out["acc"] = ce_.cpu().numpy(), acc.cpu().numpy()
    out["counts"] = counts
    return out


def rank_main(rank: int, spec: dict) -> dict:
    """One rank of the test's group: the dp = 2 step cases, then the
    SNR-parallel sweeps, then `cli train --distributed --dp 2` and `cli
    evaluate --distributed --snr-parallel 2`; -> what each returned."""
    torch.set_num_threads(1)
    device = spec["device"]
    backend = pmesh.initialize_distributed(torch.device(device).type)
    if device != "cpu":
        device = str(pmesh.rank_device())
    cfg = spec["cfg"]
    out = {"backend": backend, "world": pmesh.world_size(), "steps": {},
           "jax": {}}
    dp = pmesh.make_mesh(dp=pmesh.world_size(), snr=1)
    for key, kw in spec["steps"].items():
        out["steps"][key] = run_case(cfg=cfg, device=device, mesh=dp, **kw)
    for key, kw in spec.get("jax", {}).items():
        out["jax"][key] = run_case(cfg=spec["jax_cfg"], device=device,
                                   mesh=dp, **kw)
    if "sweeps" in spec:
        snr = pmesh.make_mesh(dp=1, snr=pmesh.world_size())
        out["sweeps"] = run_sweeps(spec["sweep_cfg"], device=device,
                                   mesh=snr, **spec["sweeps"])
    if "cli" in spec:
        out["cli"] = {}
        for key, argv in spec["cli"].items():
            os.makedirs(argv[argv.index("--log-save-path") + 1],
                        exist_ok=True)
            res = cli.main(argv)
            out["cli"][key] = {k: res[k] for k in ("losses", "table")
                               if k in res}
            if "losses" in out["cli"][key]:
                out["cli"][key]["losses"] = res["losses"].numpy()
    return out
