"""The port's partitioned LM program (DTensors on a ``DeviceMesh``: FSDP on
"data", TP/EP on "model") against the port's one-device program and the
reference's (``repro``), for reduced phi3-mini-3.8b (dense),
gemma2-27b (local/global), deepseek-moe-16b (EP on "model",
``DISPATCH_GROUPS`` = the "data" size, as the reference's dry run sets it)
and zamba2-7b (hybrid SSM).

Four ``gloo`` processes (fresh ``python`` processes running this file,
``init_method="file://<tmp>/…"``, one thread each, spawned once for the
module, with a join timeout) run every arch on ``(data=2, model=2)`` in
fp32 and bf16 and on ``(pod=2, data=1, model=2)`` in fp32: one
``make_train_step`` (loss, metrics, the whole updated state and so, from
its first moment, every gradient it used), ``prefill_forward``'s
last-token logits (under ``torch.inference_mode``, as a server runs it)
and three ``make_serve_step`` decode steps after ``pad_prefill_caches``,
then one more after ``reset_decode_slot`` of slot 1, and on ``(2, 2)`` a
crash and resume through ``train_loop``, a microbatched train step
(``MB`` = 2 rows a microbatch of B = 4, the first ``MB_T`` = 16 tokens
of the batch) of every arch in fp32 and of
phi3 in bf16 (counted), and the launcher (``launch.train.main`` with
``--model-axis 2 --microbatch 2``) in the same group. Rank 0 writes the
whole tensors. Meanwhile a fifth
process runs the reference (``jax.jit``; the MoE arch's bf16 prefill and
decode op by op, as ``tests/test_torch_lm.py`` runs them) from the same
parameters (the port's ``init_lm``, seed 0), its microbatched
``make_train_step`` included, and this one the port's one-device program
(and launcher).

Bounds (the same math in other summation orders: the row-parallel
all-reduces, the loss, the global norm):
* fp32: within ``1e-5 * max|want|``; a gradient against the reference's
  within the one-device program's own bound, ``2e-5 * max|g| + 1e-7``
  (``tests/test_torch_train_lm.py``); the updated masters as
  ``tests/test_torch_train_step.py`` holds them (within ``2.2 * lr``
  everywhere, within ``1e-6 + 1e-5 |w|`` where the gradient is not tiny);
* bf16: within the reference's serving bound ``atol = rtol = 0.08``
  (``tests/test_serve.py:73``); the state within ``2.2 * lr`` (a bf16
  leaf plus its rounding);
* a microbatched step (bf16 gradient sums, whose roundings may flip
  between summation orders): loss and grad_norm within ``1e-5`` relative,
  the updated masters within ``2.2 * lr``.

The collectives of each bf16 train step on ``(2, 2)`` (the parameters'
dtype as initialised), counted by ``CountingMode`` on rank 0, are only
FSDP's weight all-gathers and gradient reduce-scatters over "data",
"model"'s tensor-parallel all-reduces and MoE's resharding, the loss's and
the global norm's reductions; no all-gather over "data" of a ``[B, T,
d_model]`` activation; microbatched, each microbatch gathers the
weights and reduce-scatters its gradients again. Rank 0's FLOPs and
collective bytes of reduced phi3's step, plain and microbatched, equal
what the dry run counts for the same step on ``meta`` under a ``fake``
group of four ranks in this process.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
ARCHS = ("phi3-mini-3.8b", "gemma2-27b", "deepseek-moe-16b", "zamba2-7b")
MESHES = {"2x2": {"data": 2, "model": 2},
          "pod2x1x2": {"pod": 2, "data": 1, "model": 2}}
PRECS = ("fp32", "bf16")
# (mesh, precision) pairs run: bf16 on the 2-D mesh only (time)
RUNS = (("2x2", "fp32"), ("2x2", "bf16"), ("pod2x1x2", "fp32"))
WORLD = 4
B, T = 4, 48            # train: > gemma2's window of 32 (banded layers)
PB, PT, MAXS, STEPS = 4, 16, 24, 3       # prefill, cache, decode steps
CH = dict(q_chunk=16, kv_chunk=16, ssd_chunk=16)
KW = dict(peak_lr=1e-3, warmup=1, total=10, loss_chunk=16, **CH)
FP32_REL = 1e-5
BF16_TOL = 0.08
# a hang guard: the processes take ~100-110 s alone, 2-3x under a loaded
# suite
JOIN_S = 450.0
RESTART_STEPS = 4
MB, MB_T = 2, 16        # rows a microbatch (of B); the tokens it takes
# the archs whose microbatched step is also held against the reference's
# (a dense and a MoE family; the one-device microbatched step of every arch
# is held against the reference in tests/test_torch_train_step_mb.py)
MB_REF_ARCHS = ("phi3-mini-3.8b", "deepseek-moe-16b")
LAUNCH_REL = 1e-3      # the launcher's losses, mesh against one device
LAUNCH = ["--model-axis", "2", "--microbatch", "2", "--device", "cpu",
          "--steps", "2", "--batch", "4", "--seq", "16"]


def groups(sizes):
    """DISPATCH_GROUPS for a mesh: its "data" size (the reference's
    ``lower_and_compile``)."""
    return sizes.get("data", 1)


# ---------------------------------------------------------------------------
# the four processes (this file run as a script; no jax here)
# ---------------------------------------------------------------------------
def _tree_paths(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tree_paths(v, f"{path}.{k}" if path else str(k)))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_tree_paths(getattr(tree, k),
                                   f"{path}.{k}" if path else k))
        return out
    return {} if tree is None else {path: tree}


def _partitioned(arch, prec, sizes, mesh, names, wd, count):
    """One arch at one precision on ``mesh``: every result whole."""
    from repro_torch import sharding as S
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm, moe
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.step import (TrainState, make_serve_step,
                                        make_train_step, whole)
    cfg = get_reduced(arch)
    params = torch.load(os.path.join(wd, f"params_{arch}_{prec}.pt"))
    data = torch.load(os.path.join(wd, f"batch_{arch}.pt"))
    moe.DISPATCH_GROUPS = groups(sizes)

    def placed():
        fresh = tree_map(torch.clone, params)
        return S.distribute(fresh, S.param_specs(fresh, mesh), mesh)

    state = TrainState(placed(), None)
    out = _step_once(make_train_step(cfg, **KW),
                     state._replace(opt=adamw_init(state.params)),
                     {"inputs": data["x"], "labels": data["y"]}, names,
                     count)
    params_d = placed()
    with torch.inference_mode():       # as a server runs it
        lg, st = lm.prefill_forward(cfg, params_d, data["prompt"], **CH)
        out["prefill"] = whole(lg)
    st = lm.pad_prefill_caches(cfg, st, MAXS)
    serve = make_serve_step(cfg)
    out["decode"] = []
    for i in range(STEPS):
        _, lg, st = serve(params_d, st, data["tokens"][:, i:i + 1])
        out["decode"].append(lg)
    # slot 1 recycled, then one more step
    with torch.inference_mode():
        st = lm.reset_decode_slot(cfg, lm.track_slot_starts(st, PB), 1)
    out["decode"].append(serve(params_d, st, data["tokens"][:, :1])[1])
    return out


def _step_once(step, state, batch, names, count):
    """One train step: metrics and state whole; with ``count``, rank 0's
    FLOPs, collective bytes and collectives (group names as the mesh's
    dims)."""
    from repro_torch.analysis.counters import count_call
    from repro_torch.train.step import whole
    out = {}
    if count:
        (state, metrics), c = count_call(step, state, batch)
        out["counts"] = {"flops": c.flops, "coll_bytes": c.coll_bytes}
        out["collectives"] = [(kind, names.get(g, g), size, shapes, n)
                              for kind, g, size, shapes, n in c.collectives]
    else:
        state, metrics = step(state, batch)
    out["metrics"] = {k: whole(v) for k, v in metrics.items()}
    out["state"] = {k: whole(v) for k, v in _tree_paths(state).items()}
    return out


def _microbatched(arch, prec, sizes, mesh, names, wd, count):
    """One train step of ``MB``-row microbatches on ``mesh``, the whole
    batch handed to every rank."""
    from repro_torch import sharding as S
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.step import TrainState, make_train_step
    params = torch.load(os.path.join(wd, f"params_{arch}_{prec}.pt"))
    data = torch.load(os.path.join(wd, f"batch_{arch}.pt"))
    moe.DISPATCH_GROUPS = groups(sizes)
    p = tree_map(torch.clone, params)
    p = S.distribute(p, S.param_specs(p, mesh), mesh)
    step = make_train_step(get_reduced(arch), microbatch=MB, **KW)
    return _step_once(step, TrainState(p, adamw_init(p)),
                      {"inputs": data["x"][:, :MB_T],
                       "labels": data["y"][:, :MB_T]}, names, count)


def _restart(mesh, wd):
    """Reduced phi3 on ``mesh`` through ``train_loop``: uninterrupted, then
    crashed at step 3 with checkpoints every 2 steps and resumed; the global
    norm of a tree with replicated leaves beside the one-device norm."""
    from repro_torch import sharding as S
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import token_batch_fn
    from repro_torch.optim.adamw import adamw_init, global_norm, tree_map
    from repro_torch.train.loop import train_loop
    from repro_torch.train.step import TrainState, make_train_step, whole
    from torch.distributed.tensor import Shard
    cfg = get_reduced("phi3-mini-3.8b")
    params = torch.load(os.path.join(wd, "params_phi3-mini-3.8b_fp32.pt"))

    def fresh():
        p = tree_map(torch.clone, params)
        p = S.distribute(p, S.param_specs(p, mesh), mesh)
        return TrainState(p, adamw_init(p))

    step = make_train_step(cfg, **KW)
    bf = token_batch_fn(batch=B, seq=16, vocab=cfg.vocab)
    kw = dict(train_step=step, batch_fn=bf, n_steps=RESTART_STEPS,
              log_fn=lambda m: None)
    full = train_loop(state=fresh(), **kw)
    ck = CheckpointManager(os.path.join(wd, "ckpt"))
    try:
        train_loop(state=fresh(), ckpt=ck, ckpt_every=2, crash_at=3, **kw)
    except RuntimeError:
        pass
    res = train_loop(state=fresh(), ckpt=ck, ckpt_every=2, **kw)
    d = fresh().params
    return {"full": full["history"], "resumed": res["history"],
            "full_state": {k: whole(v)
                           for k, v in _tree_paths(full["state"]).items()},
            "resumed_state": {k: whole(v) for k, v
                              in _tree_paths(res["state"]).items()},
            "norm": float(global_norm(d)), "norm_one": float(
                global_norm(params)),
            "replicated": sum(all(not isinstance(q, Shard)
                                  for q in t.placements)
                              for t in _tree_paths(d).values())}


def _worker(rank, init_file, wd):
    import torch.distributed as dist
    sys.path.insert(0, SRC)
    from repro_torch.launch.mesh import make_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD)
    try:
        for mname, sizes in MESHES.items():
            mesh = make_device_mesh(sizes, device="cpu")
            names = {mesh.get_group(i).group_name: n
                     for i, n in enumerate(mesh.mesh_dim_names)}
            names[dist.group.WORLD.group_name] = "world"
            for arch in ARCHS:
                for prec in (p for m, p in RUNS if m == mname):
                    res = _partitioned(arch, prec, sizes, mesh, names, wd,
                                       count=(mname == "2x2"
                                              and prec == "bf16"))
                    if rank == 0:
                        torch.save(res, os.path.join(
                            wd, f"res_{mname}_{arch}_{prec}.pt"))
            if mname == "2x2":
                res = _restart(mesh, wd)
                if rank == 0:
                    torch.save(res, os.path.join(wd, "restart.pt"))
                mb = {(a, "fp32"): _microbatched(a, "fp32", sizes, mesh,
                                                 names, wd, count=False)
                      for a in ARCHS}
                mb[ARCHS[0], "bf16"] = _microbatched(
                    ARCHS[0], "bf16", sizes, mesh, names, wd, count=True)
                from repro_torch.launch import train as launcher
                out = launcher.main(LAUNCH)    # in this group
                if rank == 0:
                    torch.save(mb, os.path.join(wd, "mb.pt"))
                    torch.save([h["loss"] for h in out["history"]],
                               os.path.join(wd, "launch.pt"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# this process: inputs, the two one-device programs, the comparisons
# ---------------------------------------------------------------------------
def _inputs(cfg, rng):
    x = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    y = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    y[:, ::4] = -1
    prompt = rng.integers(0, cfg.vocab, (PB, PT)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab, (PB, STEPS)).astype(np.int32)
    return {"x": x, "y": y, "prompt": prompt, "tokens": tokens}


def _reference(cfg, rp, data, prec):
    """The reference's one-device results under ``jax.jit``: the loss,
    every gradient and their global norm (fp32), the forward loss (bf16),
    the prefill and decode logits (op by op for the MoE archs in bf16, as
    ``tests/test_torch_lm.py`` runs them: jit's bf16 fusion flips a router
    near-tie)."""
    import contextlib
    import functools

    import jax
    import jax.numpy as jnp
    from repro.models import lm as R
    jit = jax.jit
    out = {}
    x, y = jnp.asarray(data["x"]), jnp.asarray(data["y"])
    loss_fn = functools.partial(R.lm_loss, cfg, loss_chunk=16, **CH)
    if prec == "fp32":
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: loss_fn(p, x, y), has_aux=True))(rp)
        out["grads"] = g
        out["grad_norm"] = float(jnp.sqrt(sum(
            jnp.sum(jnp.square(t)) for t in jax.tree_util.tree_leaves(g))))
    else:
        loss, _ = jit(loss_fn)(rp, x, y)
    out["loss"] = loss
    eager = prec == "bf16" and cfg.family == "moe"
    with jax.disable_jit() if eager else contextlib.nullcontext():
        lg, st = jit(functools.partial(R.prefill_forward, cfg, **CH))(
            rp, jnp.asarray(data["prompt"]))
        out["prefill"] = lg
        st = R.pad_prefill_caches(cfg, st, MAXS)
        step = jit(functools.partial(R.decode_step, cfg))
        dec = []
        for i in range(STEPS):
            lg, st = step(rp, jnp.asarray(data["tokens"][:, i:i + 1]), st)
            dec.append(lg)
        st = R.reset_decode_slot(cfg, R.track_slot_starts(st, PB), 1)
        dec.append(step(rp, jnp.asarray(data["tokens"][:, :1]), st)[0])
    out["decode"] = dec
    return out


def _reference_mb(cfg, rp, data):
    """The reference's microbatched ``make_train_step`` under ``jax.jit``
    (a scan over ``MB``-row microbatches, bf16 gradient sums)."""
    import jax
    import jax.numpy as jnp
    from repro.optim.adamw import adamw_init
    from repro.train.step import TrainState, make_train_step
    step = jax.jit(make_train_step(cfg, microbatch=MB, **KW))
    state, m = step(TrainState(rp, adamw_init(rp)),
                    {"inputs": jnp.asarray(data["x"][:, :MB_T]),
                     "labels": jnp.asarray(data["y"][:, :MB_T])})
    return {"metrics": m, "params": state.params}


def _one_device(pcfg, params, data, prec):
    """The port's one-device results."""
    from repro_torch.models import lm as P
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.step import (TrainState, make_serve_step,
                                        make_train_step)
    out = {}
    x, y = torch.from_numpy(data["x"]), torch.from_numpy(data["y"])
    p = tree_map(torch.clone, params)
    state, m = make_train_step(pcfg, **KW)(TrainState(p, adamw_init(p)),
                                           {"inputs": x, "labels": y})
    out["metrics"], out["state"] = m, _paths(state)
    lg, st = P.prefill_forward(pcfg, params, torch.from_numpy(data["prompt"]),
                               **CH)
    out["prefill"] = lg
    st = P.pad_prefill_caches(pcfg, st, MAXS)
    serve = make_serve_step(pcfg)
    out["decode"] = []
    for i in range(STEPS):
        _, lg, st = serve(params, st,
                          torch.from_numpy(data["tokens"][:, i:i + 1]))
        out["decode"].append(lg)
    st = P.reset_decode_slot(pcfg, P.track_slot_starts(st, PB), 1)
    out["decode"].append(serve(params, st,
                               torch.from_numpy(data["tokens"][:, :1]))[1])
    return out


def _one_device_mb(pcfg, params, data):
    """The port's one-device microbatched step: metrics and state."""
    from repro_torch.optim.adamw import adamw_init, tree_map
    from repro_torch.train.step import TrainState, make_train_step
    p = tree_map(torch.clone, params)
    state, m = make_train_step(pcfg, microbatch=MB, **KW)(
        TrainState(p, adamw_init(p)),
        {"inputs": torch.from_numpy(data["x"][:, :MB_T]),
         "labels": torch.from_numpy(data["y"][:, :MB_T])})
    return {"metrics": m, "state": _paths(state)}


def step_grads(res):
    """The gradients a first AdamW step used, from its first moment: ``m =
    (1 - b1) * g * clip`` from zero, ``clip = min(1, 1 / max(norm,
    1e-9))`` (``max_grad_norm`` 1): two fp32 roundings, so within a few
    ulp of the gradients."""
    norm = float(res["metrics"]["grad_norm"])
    clip = min(1.0, 1.0 / max(norm, 1e-9))
    return {k[len("opt.m."):]: _np(v) / 0.1 / clip
            for k, v in res["state"].items() if k.startswith("opt.m.")}


def _paths(tree):
    return _tree_paths(tree)


def _ref_paths(tree):
    """A reference tree by the port's paths (dicts and named tuples)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update({f"{k}.{p}" if p else str(k): t
                        for p, t in _ref_paths(v).items()})
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update({f"{k}.{p}" if p else k: t
                        for p, t in _ref_paths(getattr(tree, k)).items()})
        return out
    return {} if tree is None else {"": tree}


def _needed():
    """The (arch, precision, DISPATCH_GROUPS) one-device runs the
    comparisons need."""
    from repro_torch.configs import get_reduced
    return sorted({(a, p, groups(MESHES[m])
                    if get_reduced(a).family == "moe" else 1)
                   for m, p in RUNS for a in ARCHS})


def _mb_groups(arch):
    """DISPATCH_GROUPS of the microbatched runs (on (2, 2))."""
    from repro_torch.configs import get_reduced
    return (groups(MESHES["2x2"]) if get_reduced(arch).family == "moe"
            else 1)


def _jax_tree(tree):
    """The port's parameter tree as the reference's (the same keys and
    shapes, ``params_from_jax``'s converse), each leaf in its dtype."""
    import jax.numpy as jnp
    import ml_dtypes
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(tree.numpy())


def _reference_process(wd):
    """Every needed reference run, written to ``wd`` (a process of its own,
    beside the four ranks and this one's port runs), from the parameters
    the ranks take."""
    import pickle

    import jax
    from repro.configs import get_reduced
    from repro.models import moe as RM
    out = {}
    for arch, prec, gs in _needed():
        cfg = get_reduced(arch)
        rp = _jax_tree(torch.load(os.path.join(wd,
                                               f"params_{arch}_{prec}.pt")))
        data = dict(np.load(os.path.join(wd, f"batch_{arch}.npz")))
        RM.DISPATCH_GROUPS = gs
        res = _reference(cfg, rp, data, prec)
        out[arch, prec, gs] = jax.tree.map(np.asarray, res)
        if prec == "fp32" and gs == _mb_groups(arch) \
                and arch in MB_REF_ARCHS:
            out["mb", arch] = jax.tree.map(np.asarray,
                                           _reference_mb(cfg, rp, data))
    with open(os.path.join(wd, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)


def _join(procs, t0, what):
    """Waits for ``procs`` until ``JOIN_S`` after ``t0`` (then kills them):
    the error tails of those that failed, and the seconds at which the
    last one ended."""
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(
                timeout=max(1.0, JOIN_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise RuntimeError(f"{what} {r} did not finish in {JOIN_S}s")
        if p.returncode:
            errs.append(f"{what} {r} exit {p.returncode}: {err[-3000:]}")
    return errs, time.perf_counter() - t0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import pickle

    from repro_torch.configs import get_reduced as port_reduced
    from repro_torch.models import lm as P
    from repro_torch.models import moe as PM
    wd = str(tmp_path_factory.mktemp("sharded"))
    t_in = time.perf_counter()
    rng = np.random.default_rng(7)
    inputs = {}
    for arch in ARCHS:
        pcfg = port_reduced(arch)
        inputs[arch] = _inputs(pcfg, rng)
        np.savez(os.path.join(wd, f"batch_{arch}.npz"), **inputs[arch])
        torch.save({k: torch.from_numpy(v) for k, v in inputs[arch].items()},
                   os.path.join(wd, f"batch_{arch}.pt"))
        params = P.init_lm(pcfg, torch.Generator().manual_seed(0),
                           device="cpu")
        for prec in PRECS:
            t = params if prec == "bf16" else P._tree_map(
                lambda a: a.float(), params)
            torch.save(t, os.path.join(wd, f"params_{arch}_{prec}.pt"))
    # one thread a process: four processes on a shared host
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    init_file = os.path.join(wd, "pg_init")
    me = os.path.abspath(__file__)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, me, "worker", str(r),
                               init_file, wd], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(WORLD)]
    ref = subprocess.Popen([sys.executable, me, "reference", wd],
                           env=dict(os.environ, PYTHONPATH=SRC),
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    one = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch, prec, gs in _needed():
            PM.DISPATCH_GROUPS = gs
            params = torch.load(os.path.join(wd, f"params_{arch}_{prec}.pt"))
            one[arch, prec, gs] = _one_device(port_reduced(arch), params,
                                              inputs[arch], prec)
        for arch in ARCHS:
            PM.DISPATCH_GROUPS = _mb_groups(arch)
            params = torch.load(os.path.join(wd, f"params_{arch}_fp32.pt"))
            one["mb", arch] = _one_device_mb(port_reduced(arch), params,
                                             inputs[arch])
        PM.DISPATCH_GROUPS = 1
        from repro_torch.launch import train as launcher
        launch_one = [h["loss"] for h in launcher.main(LAUNCH)["history"]]
        t_one = time.perf_counter() - t0
    finally:
        PM.DISPATCH_GROUPS = 1
        torch.set_num_threads(threads)
        errs, t_ranks = _join(procs, t0, "rank")
        errs_ref, t_ref = _join([ref], t0, "reference")
        if errs + errs_ref:
            raise RuntimeError("\n".join(errs + errs_ref))
    with open(os.path.join(wd, "reference.pkl"), "rb") as f:
        refs = pickle.load(f)
    want = {k: (refs[k], one[k]) for k in one if k[0] != "mb"}
    got = {(m, a, p): torch.load(os.path.join(wd, f"res_{m}_{a}_{p}.pt"))
           for m, p in RUNS for a in ARCHS}
    restart = torch.load(os.path.join(wd, "restart.pt"))
    restart["ckpt"] = os.path.join(wd, "ckpt")
    mb = {"got": torch.load(os.path.join(wd, "mb.pt")),
          "one": {a: one["mb", a] for a in ARCHS},
          "ref": {a: refs["mb", a] for a in MB_REF_ARCHS},
          "launch": torch.load(os.path.join(wd, "launch.pt")),
          "launch_one": launch_one}
    print(f"[sharded] inputs {t0 - t_in:.1f}s; port one-device "
          f"{t_one:.1f}s, the ranks {t_ranks:.1f}s, the reference "
          f"{t_ref:.1f}s")
    return {"got": got, "want": want, "restart": restart, "mb": mb,
            "s": time.perf_counter() - t0}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, dtype=np.float32)


def _close(got, want, prec, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if prec == "fp32":
        err = float(np.abs(got - want).max())
        assert err <= FP32_REL * max(float(np.abs(want).max()), 1e-30), \
            f"{what}: {err}"
    else:
        np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL,
                                   err_msg=what)


CASES = [(m, a, p) for m, p in RUNS for a in ARCHS]


def _pair(runs, m, a, p):
    got = runs["got"][m, a, p]
    gs = groups(MESHES[m])
    key = (a, p, gs) if (a, p, gs) in runs["want"] else (a, p, 1)
    return got, runs["want"][key]


@pytest.mark.parametrize("m,a", [(m, a) for m in MESHES for a in ARCHS])
def test_loss_and_every_gradient(runs, m, a):
    """The train step's loss and every gradient it used (from its first
    moment, :func:`step_grads`) against the one-device step's and the
    reference's ``jax.value_and_grad`` of ``lm_loss``."""
    got, (ref, one) = _pair(runs, m, a, "fp32")
    _close(got["metrics"]["loss"], one["metrics"]["loss"], "fp32",
           "loss vs one device")
    _close(got["metrics"]["loss"], ref["loss"], "fp32", "loss vs reference")
    g_got, g_one = step_grads(got), step_grads(one)
    rg = _ref_paths(ref["grads"])
    assert set(g_got) == set(g_one) == set(rg)
    for k, g in g_got.items():
        _close(g, g_one[k], "fp32", f"grad {k} vs one device")
        # the one-device program's own bound against the reference's
        # gradients (tests/test_torch_train_lm.py)
        want = _np(rg[k])
        err = float(np.abs(g - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()) + 1e-7, \
            f"grad {k} vs reference: {err}"


def _master_close(got, want, grad, lr, prec, what):
    """Within ``2.2 * lr`` (a bf16 leaf: plus its rounding, 2^-8 of |w|
    each side); fp32 also as the module docstring says."""
    w, want = _np(got), _np(want)
    d = np.abs(w - want)
    slack = 2.0 ** -7 * np.abs(want) if got.dtype == torch.bfloat16 else 0
    assert (d <= 2.2 * lr + slack).all(), (what, float(d.max()))
    if prec == "fp32" and grad is not None:
        g = np.abs(_np(grad))
        sure = g >= 1e-3 * g.max()
        bad = sure & (d > 1e-6 + 1e-5 * np.abs(want))
        assert not bad.any(), (what, float(d[sure].max()))


@pytest.mark.parametrize("m,a,p", CASES)
def test_train_step(runs, m, a, p):
    """One step: its loss against both programs; its grad_norm against the
    one-device step's and (fp32) the reference's gradients'; lr and the
    step count equal; every leaf of the updated state against the
    one-device step's (the one-device step is held to the reference's in
    ``tests/test_torch_train_step.py``)."""
    got, (ref, one) = _pair(runs, m, a, p)
    tol = FP32_REL if p == "fp32" else BF16_TOL
    checks = [("loss", float(one["metrics"]["loss"]), "one device"),
              ("ce", float(one["metrics"]["ce"]), "one device"),
              ("grad_norm", float(one["metrics"]["grad_norm"]), "one device")]
    if p == "fp32":
        checks.append(("grad_norm", ref["grad_norm"], "reference"))
    checks.append(("loss", float(ref["loss"]), "reference"))
    for k, want, who in checks:
        g = float(got["metrics"][k])
        assert abs(g - want) <= tol * abs(want), (k, who, g, want)
    lr = float(got["metrics"]["lr"])
    assert lr == float(one["metrics"]["lr"])
    assert set(got["state"]) == set(one["state"])
    grads = step_grads(one) if p == "fp32" else {}
    for k, v in got["state"].items():
        want = one["state"][k]
        if k == "opt.step":
            assert int(v) == int(want) == 1
        elif k.startswith(("opt.master", "params")):
            leaf = k.split(".", 2)[-1] if k.startswith("opt.") else k[7:]
            _master_close(v, want, grads.get(leaf), lr, p, k)
        elif p == "fp32":      # the moments: (1 - b) g and (1 - b) g^2
            _close(v, want, p, k)


@pytest.mark.parametrize("m,a,p", CASES)
def test_prefill_and_decode(runs, m, a, p):
    got, (ref, one) = _pair(runs, m, a, p)
    assert tuple(got["prefill"].shape) == (PB, 256)
    _close(got["prefill"], one["prefill"], p, "prefill vs one device")
    _close(got["prefill"], ref["prefill"], p, "prefill vs reference")
    assert len(got["decode"]) == STEPS + 1      # + the recycled slot's step
    for i, lg in enumerate(got["decode"]):
        _close(lg, one["decode"][i], p, f"decode {i} vs one device")
        _close(lg, ref["decode"][i], p, f"decode {i} vs reference")


def _weight_shards(a):
    """The numel of one layer's local shard of every parameter on (2, 2):
    what an FSDP gather over "data" takes in."""
    from repro_torch import sharding as S
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm
    cfg = get_reduced(a)
    params = lm.init_lm(cfg, None, device="meta")
    sizes = MESHES["2x2"]
    specs = _tree_paths(S.param_specs(params, sizes))
    out = set()
    for path, t in _tree_paths(params).items():
        depth = 0
        if path.startswith(("dense_layers.", "tail.", "lora.")):
            depth = 1
        elif path.startswith("layers."):
            depth = 2 if (cfg.family == "hybrid"
                          or cfg.local_global_period == 2) else 1
        n = int(np.prod(t.shape[depth:]))
        for ax in specs[path][depth:]:
            for name in ((ax,) if isinstance(ax, str) else (ax or ())):
                n //= sizes[name]
        out.add(n)
    return out


@pytest.mark.parametrize("a", ARCHS)
def test_collectives_are_fsdp_and_tp(runs, a):
    """Every collective of the bf16 train step on (2, 2): an all-gather over
    "data" gathers a weight shard (never a [B, T, d] activation); "model"
    carries the tensor-parallel all-reduces and reduce-scatters and MoE's
    resharding; the world group only the global norm."""
    got, _ = _pair(runs, "2x2", a, "bf16")
    _check_fsdp_and_tp(got["collectives"], a)


def _check_fsdp_and_tp(coll, a):
    from repro_torch.configs import get_reduced
    cfg = get_reduced(a)
    kinds = {(k, g) for k, g, *_ in coll}
    assert ("all-gather", "data") in kinds
    assert ("reduce-scatter", "data") in kinds
    assert ("all-reduce", "model") in kinds
    assert all(k != "all-to-all" for k, *_ in coll), kinds
    weights = _weight_shards(a)
    # the world group: the global norm's one all-reduce of a scalar
    world = [c for c in coll if c[1] == "world"]
    assert [(k, shp) for k, _, _, shp, _ in world] == [("all-reduce", [()])]
    for kind, g, size, shapes, n in coll:
        assert g in ("data", "model", "world"), (kind, g)
        if kind == "all-gather" and g == "data":
            assert int(np.prod(shapes[0])) // size in weights, (kind, shapes)
            assert not (len(shapes[0]) == 3 and shapes[0][1:] ==
                        (T, cfg.d_model)), (kind, g, shapes)


def test_microbatched_collectives_are_fsdp_and_tp(runs):
    """phi3's microbatched bf16 step on (2, 2): the same kinds of
    collectives, and each of the B / MB microbatches gathers every weight
    shard over "data" and reduce-scatters its gradients there again."""
    a = ARCHS[0]
    coll = runs["mb"]["got"][a, "bf16"]["collectives"]
    _check_fsdp_and_tp(coll, a)
    plain, _ = _pair(runs, "2x2", a, "bf16")

    def over_data(cs, kind):
        return sorted((tuple(map(tuple, shp)), n) for k, g, _, shp, n in cs
                      if k == kind and g == "data")
    for kind in ("all-gather", "reduce-scatter"):
        assert over_data(coll, kind) == sorted(
            over_data(plain["collectives"], kind) * (B // MB)), kind


def _fake_count(microbatch=None, seq=T):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    chunks = dict(CH, loss_chunk=16, microbatch=microbatch)
    c, _ = D.trace_partitioned(get_reduced("phi3-mini-3.8b"),
                               ShapeConfig("c", "train", seq, B),
                               MESHES["2x2"], chunks=chunks)
    return c


def test_fake_group_count_equals_the_gloo_run(runs):
    """The dry run's count of reduced phi3's train step, rank 0 of a fake
    four-rank group on meta, against rank 0's count of the same step in
    the four gloo processes: FLOPs and collective bytes of every kind
    equal."""
    import torch.distributed as dist
    got = runs["got"]["2x2", "phi3-mini-3.8b", "bf16"]["counts"]
    c = _fake_count()
    assert not dist.is_initialized()
    assert got["flops"] == c.flops > 0
    assert got["coll_bytes"] == c.coll_bytes
    assert set(c.coll_bytes) >= {"all-gather", "reduce-scatter",
                                 "all-reduce"}


def test_fake_group_count_equals_the_gloo_run_microbatched(runs):
    """The same for the microbatched step (a dry-run row whose chunks carry
    ``microbatch``): equal counts, the plain step's FLOPs."""
    got = runs["mb"]["got"]["phi3-mini-3.8b", "bf16"]["counts"]
    c = _fake_count(MB, MB_T)
    assert got["flops"] == c.flops == _fake_count(seq=MB_T).flops
    assert got["coll_bytes"] == c.coll_bytes


@pytest.mark.parametrize("a", ARCHS)
def test_microbatched_train_step(runs, a):
    """A step of ``MB``-row microbatches on (2, 2) in fp32 against the
    port's one-device microbatched step and, for ``MB_REF_ARCHS``, the
    reference's (``jax.jit`` of ``make_train_step(microbatch=MB)``): loss,
    grad_norm and ce (the last microbatch's) within ``1e-5`` relative, lr
    equal, every updated parameter and master within ``2.2 * lr``."""
    got = runs["mb"]["got"][a, "fp32"]
    one, ref = runs["mb"]["one"][a], runs["mb"]["ref"].get(a)
    wants = [(one["metrics"], "one device")]
    if ref is not None:
        wants.append((ref["metrics"], "reference"))
    for k in ("loss", "grad_norm", "ce"):
        g = float(got["metrics"][k])
        for m, who in wants:
            want = float(m[k])
            assert abs(g - want) <= FP32_REL * abs(want), (k, who, g, want)
    lr = float(got["metrics"]["lr"])
    assert lr == float(one["metrics"]["lr"])
    assert set(got["state"]) == set(one["state"])
    rp = _ref_paths(ref["params"]) if ref is not None else {}
    for k, v in got["state"].items():
        if k.startswith(("opt.master", "params")):
            _master_close(v, one["state"][k], None, lr, "fp32", k)
        if k.startswith("params.") and rp:
            _master_close(v, rp[k[len("params."):]], None, lr, "fp32",
                          f"{k} vs reference")


def test_launcher_microbatched_on_the_mesh(runs):
    """``launch.train.main(--model-axis 2 --microbatch 2)`` in the ranks'
    group (a 2 x 2 mesh) against the same launch on one device: both run
    their steps on the same rows from the same parameters, so each loss
    agrees within ``LAUNCH_REL``: well above what the mesh's sums in other
    orders move the bf16 model's losses by, below what the same parameters
    on other rows of the batch (a rank's own, or the next step's) move them
    by."""
    got, want = runs["mb"]["launch"], runs["mb"]["launch_one"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert np.isfinite(g) and abs(g - w) <= LAUNCH_REL * abs(w), (g, w)


def test_distributed_crash_and_resume_is_bit_equal(runs):
    """A partitioned run crashed at step 3 and resumed from its step-2
    checkpoint: every metric of every step it ran again and every leaf of
    the final state bit-equal to the uninterrupted run's."""
    r = runs["restart"]
    assert len(r["full"]) == RESTART_STEPS and len(r["resumed"]) == 2
    assert r["full"][2:] == r["resumed"]
    assert set(r["full_state"]) == set(r["resumed_state"])
    for k, v in r["full_state"].items():
        assert torch.equal(v, r["resumed_state"][k]), k


def test_distributed_checkpoint_is_the_one_device_format(runs):
    """The partitioned run's last checkpoint (whole leaves, written by rank
    0) restores into a one-device state, equal to the run's final state."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.train.step import init_train_state
    r = runs["restart"]
    ck = CheckpointManager(r["ckpt"])
    assert ck.latest_step() == RESTART_STEPS
    like = init_train_state(get_reduced("phi3-mini-3.8b"),
                            torch.Generator().manual_seed(0), device="cpu")
    got = _tree_paths(ck.restore(RESTART_STEPS, like))
    for k, v in r["resumed_state"].items():
        assert torch.equal(got[k], v), k


def test_global_norm_counts_replicated_leaves_once(runs):
    """The distributed global norm of the fp32 parameters (norm weights
    replicated on every rank, the rest sharded) within 2 ulp of the
    one-device norm."""
    r = runs["restart"]
    assert r["replicated"] > 0
    one = np.float32(r["norm_one"])
    assert abs(np.float32(r["norm"]) - one) <= 2 * np.spacing(one)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
elif __name__ == "__main__" and sys.argv[1:2] == ["reference"]:
    sys.path.insert(0, SRC)
    _reference_process(sys.argv[2])
