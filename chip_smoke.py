#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. the card: name, power limit, torch and CUDA versions; TF32 is switched
   off for matmuls and cuDNN so every fp32 product is full fp32;
2. build K1 (``src/repro_torch/csrc/spmm_accel.cu``) with nvcc for sm_90a
   and print ptxas' registers, shared memory and spills;
3. K1 against its plain PyTorch version on the card, in both partition
   modes: zero-degree rows, degree == deg_bound, degree > C (split rows),
   F in {1, 100, 2048}, and merged batched slabs with all-zero padding
   blocks. Integer-valued graphs must match exactly;
4. the served slice: the Reddit and Arxiv analogues registered in one
   GraphServeEngine, the 25m GCN (dims 1024-2048x4-256, 256 classes) served
   layer by layer for 2 rounds, then 4 threads x 4 concurrent submits at
   width 256. Every answer is checked against the CSR oracle on the card.
   The K1 launch count of this phase must equal the number of dispatches;
5. where one served F=2048 layer spends its device time (torch.profiler),
   and K1's time per fused dispatch at F=2048 (CUDA events), beside its plain
   version, ``torch.sparse.mm`` on the same A and X (a yardstick the port
   never calls) and the memory bound; then the ``{"kernels": [...]}`` line,
   the card line, and the ``{"ok": true, ...}`` line last.

Tolerance for float results. K1 and its plain version sum a row in two
levels: at most min(deg, C) rounded products in order inside a block, then
one partial per block (ceil(deg / C) of them) in any order. The classic
bound for recursive summation gives, per element,
``|y - exact| <= k * u * (|A| @ |x|)`` with ``k = min(deg, C) + ceil(deg/C)
+ 1`` and ``u = 2**-24``. Served answers are held to that bound against an
fp64 CSR oracle; K1 and its plain version, both fp32, to twice it.
"""
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
U = 2.0 ** -24                # fp32 unit roundoff
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_FLOPS = 67e12            # H100 SXM fp32 rate outside the tensor cores
DIMS = [1024, 2048, 2048, 2048, 2048, 256]   # examples/train_gcn.py "25m"
N_CLASSES = 256
GRAPHS = ("Reddit", "Arxiv")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


def summation_k(g, C, degree_sorted):
    """Per-row k of the summation bound (see the module docstring), in the
    graph's original row order or in its degree-sorted order."""
    import numpy as np
    from repro_torch.core.graph import counting_sort_by_degree
    deg = np.diff(g.rowptr).astype(np.int64)
    if degree_sorted:
        deg = deg[counting_sort_by_degree(deg)]
    return np.minimum(deg, C) + -(-deg // C) + 1


def check_close(name, got, want, bound):
    """Elementwise |got - want| <= bound; returns the max abs error."""
    err = (got.double() - want.double()).abs()
    bad = err > bound
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside tolerance, e.g. "
            f"flat index {i}: got {got.flatten()[i].item()}, want "
            f"{want.flatten()[i].item()}, bound {bound.flatten()[i].item()}")
    return float(err.max()) if err.numel() else 0.0


def pair_bound(torch, plain, args, x, n_rows, k):
    """Twice the summation bound, for two fp32 results of the same slabs."""
    mag = plain(args[0], args[1].abs(), args[2], args[3], x.abs(), n_rows)
    kt = torch.as_tensor(k, dtype=torch.float64, device=x.device)[:, None]
    return 2 * U * kt * mag.double()


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{name}, power limit not reported"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device {name}; nvidia-smi: {card_line}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN "
        f"(allow_tf32={torch.backends.cuda.matmul.allow_tf32})")
    return name, card_line


def phase_build():
    from repro_torch.kernels.spmm_accel import build_kernel
    t0 = time.perf_counter()
    path, report = build_kernel()
    log(f"K1 built in {time.perf_counter() - t0:.1f}s -> "
        f"{os.path.relpath(path, ROOT)}")
    for line in report.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
            log(f"ptxas: {line.strip()}")
    C, R, f_tile = 256, 64, 128
    log(f"K1 dynamic shared memory per CTA at C={C}, R={R}, f_tile={f_tile}: "
        f"(R * f_tile + 3 * C + R) * 4 = {(R * f_tile + 3 * C + R) * 4} bytes")


def edge_case_graph(C, seed):
    """Integer-valued square CSR with zero-degree rows, rows of degree C
    (== deg_bound), C + 1 and 3C + 7 (split), and many small rows."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph
    rng = np.random.default_rng(seed)
    deg = np.concatenate([[0] * 5, [C] * 3, [C + 1] * 2, [3 * C + 7],
                          rng.integers(1, 40, 300), [0] * 3])
    rng.shuffle(deg)
    n = len(deg)
    rowptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=rowptr[1:])
    colidx = rng.integers(0, n, int(rowptr[-1])).astype(np.int64)
    values = rng.integers(1, 4, int(rowptr[-1])).astype(np.float32)
    return CSRGraph(rowptr, colidx, values, n)


def phase_kernel_cases(torch, dev):
    """K1 vs its plain version on ``dev``; returns the max abs error of the
    float cases."""
    import numpy as np
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                                spmm_block_slabs_plain)
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = 0.0
    n_cases = 0

    def run(label, slabs, n_rows, x, exact, k=None):
        nonlocal worst, n_cases
        args = (slabs["colidx"], slabs["values"], slabs["rowloc"],
                slabs["out_row"])
        got = spmm_block_slabs(*args, x, n_rows)
        want = spmm_block_slabs_plain(*args, x, n_rows)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: K1 differs from the plain "
                                     f"version on an integer-valued graph")
        else:
            bound = pair_bound(torch, spmm_block_slabs_plain, args, x,
                               n_rows, k)
            worst = max(worst, check_close(label, got, want, bound))
        n_cases += 1

    configs = {"tpu": PartitionConfig("tpu", 64, 4),
               "paper": PartitionConfig("paper", 12, 32)}
    int_plans = []
    for mode, cfg in configs.items():
        g_int = edge_case_graph(cfg.deg_bound, seed=len(int_plans))
        g_norm = gcn_normalize(make_power_law_graph(3000, 60000, seed=3))
        p_int = build_partition_plan(g_int, cfg, device=dev)
        p_norm = build_partition_plan(g_norm, cfg, device=dev)
        int_plans.append((p_int, g_int))
        split = int(p_int.partition.is_split.sum())
        if split == 0:
            raise AssertionError(f"{mode}: edge-case graph has no split rows")
        for F in (1, 100, 2048):
            xi = torch.randint(-4, 5, (g_int.n_cols, F), generator=gen,
                               device=dev).float()
            run(f"{mode} int F={F}", p_int.slabs, g_int.n_rows, xi, True)
            xf = torch.randn((g_norm.n_cols, F), generator=gen, device=dev)
            run(f"{mode} normalized F={F}", p_norm.slabs, g_norm.n_rows, xf,
                False, summation_k(g_norm, cfg.deg_bound, True))
        log(f"K1 == plain: {mode} mode C={cfg.deg_bound} "
            f"R={p_int.slabs['R']}, {p_int.num_blocks} blocks ({split} split)")

    # merged slabs of both modes (C and R padded to the batch max) plus a
    # tail of all-zero padding blocks
    plans = [p for p, _ in int_plans]
    b_total = sum(p.num_blocks for p in plans)
    merged, _, _, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans],
        [g.n_cols for _, g in int_plans],
        pad_blocks_to=bucket_blocks(b_total) * 2)
    n_x = sum(g.n_cols for _, g in int_plans)
    for F in (1, 100, 2048):
        xi = torch.randint(-4, 5, (n_x, F), generator=gen, device=dev).float()
        run(f"merged F={F}", merged, n_out, xi, True)
    log(f"K1 == plain: merged C={merged['C']} R={merged['R']}, {b_total} "
        f"live + {merged['colidx'].shape[0] - b_total} padding blocks")
    log(f"phase 3 ok: {n_cases} cases, integer cases exact, float max "
        f"|K1 - plain| = {worst:.3e}")
    return worst


def csr_check(torch, g, x, y, C, nnz_chunk):
    """Hold ``y`` (original row order) against the fp64 CSR oracle for A'.x,
    within the summation bound of K1's fp32 sums."""
    import numpy as np
    from repro_torch.kernels.ref import csr_spmm_ref
    vals = g.values.astype(np.float64)
    want = csr_spmm_ref(g.rowptr, g.colidx, vals, x.double(),
                        nnz_chunk=nnz_chunk)
    mag = csr_spmm_ref(g.rowptr, g.colidx, np.abs(vals), x.double().abs(),
                       nnz_chunk=nnz_chunk)
    k = torch.as_tensor(summation_k(g, C, False), dtype=torch.float64,
                        device=x.device)[:, None]
    return check_close("served", y, want, U * k * mag)


def phase_serve(torch, dev):
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_benchmark_graph
    from repro_torch.kernels.spmm_accel import spmm_block_slabs
    from repro_torch.models.layers import dense_init
    from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    graphs = {}
    for i, name in enumerate(GRAPHS):
        t0 = time.perf_counter()
        g, scale = make_benchmark_graph(name, seed=i)
        graphs[name] = gcn_normalize(g)
        log(f"{name}: {g.n_rows} nodes, {graphs[name].nnz} nnz after "
            f"gcn_normalize (edge scale {scale}), built in "
            f"{time.perf_counter() - t0:.1f}s")
    engine = GraphServeEngine(device=dev, backend="accel",
                              max_graphs_per_batch=2)
    for name, g in graphs.items():
        t0 = time.perf_counter()
        plan = engine.register_graph(name, g)
        bp = plan.partition
        log(f"{name}: plan {plan.num_blocks} blocks "
            f"({int(bp.is_split.sum())} split), C={plan.slabs['C']} "
            f"R={plan.slabs['R']}, built in {time.perf_counter() - t0:.1f}s")

    gen = torch.Generator().manual_seed(0)
    dims = DIMS + [N_CLASSES]
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    dgen = torch.Generator(device=dev).manual_seed(1)
    feats = {name: torch.randn((g.n_rows, dims[0]), generator=dgen,
                               device=dev) for name, g in graphs.items()}
    nnz_chunk = 1 << 17
    C = engine.config.deg_bound

    spmm_block_slabs.launches = 0          # main path starts here
    t_main = time.perf_counter()
    last_xw = {}
    for rnd in range(2):
        h = dict(feats)
        for li, w in enumerate(weights):
            xw = {name: h[name] @ w for name in graphs}
            reqs = engine.serve([GraphRequest(name, xw[name])
                                 for name in graphs])
            errs = []
            for r in reqs:
                errs.append(csr_check(torch, graphs[r.graph_id],
                                      xw[r.graph_id], r.out, C, nnz_chunk))
                h[r.graph_id] = (torch.relu(r.out) if li < len(weights) - 1
                                 else r.out)
            lat = ", ".join(f"{r.graph_id} {r.latency_s * 1e3:.1f}ms"
                            for r in reqs)
            log(f"round {rnd} layer {li} F={w.shape[1]}: max err "
                f"{max(errs):.2e}; latency {lat}")
            last_xw = xw
        for name in graphs:
            if not bool(torch.isfinite(h[name]).all()) or \
                    tuple(h[name].shape) != (graphs[name].n_rows, N_CLASSES):
                raise AssertionError(f"{name}: logits not finite or of shape "
                                     f"{tuple(h[name].shape)}")

    # concurrent submitters at the last layer's width (256)
    n_threads, per_thread = 4, 4
    futs = [[None] * per_thread for _ in range(n_threads)]
    latencies = []          # submit -> answer, one per request
    all_answered = threading.Event()
    lat_lock = threading.Lock()

    def record(t0):
        with lat_lock:
            latencies.append(time.perf_counter() - t0)
            if len(latencies) == n_threads * per_thread:
                all_answered.set()

    def caller(t):
        for k in range(per_thread):
            name = GRAPHS[(t + k) % len(GRAPHS)]
            t_submit = time.perf_counter()
            fut = engine.submit(name, last_xw[name] * (t + 1.0))
            fut.add_done_callback(lambda _f, t0=t_submit: record(t0))
            futs[t][k] = (name, t + 1.0, fut)

    threads = [threading.Thread(target=caller, args=(t,))
               for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("a submitter thread did not finish")
    errs = []
    for row in futs:
        for name, scalef, fut in row:
            got = fut.result(timeout=600)
            errs.append(csr_check(torch, graphs[name], last_xw[name] * scalef,
                                  got, C, nnz_chunk))
    if not all_answered.wait(timeout=600):
        raise AssertionError("not every concurrent request was answered")
    t_main = time.perf_counter() - t_main
    launches = spmm_block_slabs.launches   # main path ends here
    st = engine.stats()
    engine.close()
    log(f"concurrent: {n_threads} threads x {per_thread} submits, max err "
        f"{max(errs):.2e}, sched p50 {st['sched_p50_latency_s'] * 1e3:.1f}ms "
        f"p99 {st['sched_p99_latency_s'] * 1e3:.1f}ms; request latencies "
        f"(ms): {', '.join(f'{v * 1e3:.1f}' for v in sorted(latencies))}")
    log(f"stats: dispatches={st['batches_dispatched']} "
        f"routed_resident={st['routed_resident']} "
        f"graphs_per_dispatch={st['graphs_per_dispatch']:.2f} "
        f"requests_per_batch={st['requests_per_batch']:.2f} "
        f"cache builds={st['cache_builds']} hits={st['cache_hits']} "
        f"block_pad_ratio={st['block_pad_ratio']:.3f} "
        f"avg_dispatch={st['avg_dispatch_s'] * 1e3:.1f}ms")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured")
    log(f"K1 launches on the main path: {launches} "
        f"(dispatches {st['batches_dispatched']}); main path "
        f"{t_main:.1f}s including the oracle checks; peak device memory "
        f"{peak}")
    if launches <= 0 or launches != st["batches_dispatched"] \
            or launches != st["routed_resident"]:
        raise AssertionError(f"K1 launches {launches} != dispatches "
                             f"{st['batches_dispatched']}")
    return graphs, engine, launches


def phase_profile(torch, engine, graphs):
    """Where one served F=2048 layer spends its device time: the two dense
    products and the fused dispatch, under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.graph_engine import GraphRequest
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    w = torch.randn((2048, 2048), generator=gen, device=dev) / 2048 ** 0.5
    h = {name: torch.randn((g.n_rows, 2048), generator=gen, device=dev)
         for name, g in graphs.items()}

    def layer():
        engine.serve([GraphRequest(name, h[name] @ w) for name in graphs])
        torch.cuda.synchronize()

    layer()                                     # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        layer()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        layer()
    rows = [(evt.self_device_time_total / 1e3, evt.count, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms <= 0:
        log("profile: the profiler recorded no device time; not measured")
        return
    log(f"profile of one served F=2048 layer (both graphs): wall "
        f"{wall_ms:.1f} ms (median of 3, unprofiled), device kernels "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms * 100:.1f}% busy)")
    for ms, count, key in rows[:8]:
        log(f"profile:   {ms:9.3f} ms  {ms / busy_ms * 100:5.1f}%  x{count:<3d} "
            f"{key[:70]}")


def phase_timing(torch, graphs, engine, launches, float_err):
    """K1 at the fused F=2048 dispatch shape against its plain version, the
    library SpMM and the memory bound. Returns the kernel record."""
    import numpy as np
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                                spmm_block_slabs_plain)
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks

    dev = torch.device("cuda")
    F = 2048
    plans = [engine.plan_for(name) for name in graphs]
    b_live = sum(p.num_blocks for p in plans)
    merged, out_off, col_off, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans],
        [p.n_cols for p in plans], pad_blocks_to=bucket_blocks(b_live))
    n_x = int(col_off[-1])
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((n_x, F), generator=gen, device=dev)
    args = (merged["colidx"], merged["values"], merged["rowloc"],
            merged["out_row"], x, n_out)

    k1 = lambda: spmm_block_slabs(*args)               # noqa: E731
    plain = lambda: spmm_block_slabs_plain(*args)      # noqa: E731
    got = k1()
    want = plain()
    k = np.concatenate([summation_k(g, int(merged["C"]), True)
                        for g in graphs.values()])
    bound = pair_bound(torch, spmm_block_slabs_plain, args[:4], x, n_out, k)
    err = check_close("fused F=2048 K1 vs plain", got, want, bound)
    del bound, want
    for _ in range(2):
        k1()
    ms = cuda_ms(k1, 10)
    plain_ms = cuda_ms(plain, 2)
    zero_ms = cuda_ms(lambda: torch.zeros((n_out, F), device=dev), 10)
    tiles = []
    for f_tile in (64, 256, 512):
        spmm_block_slabs(*args, f_tile=f_tile)
        tiles.append(f"f_tile={f_tile} "
                     f"{cuda_ms(lambda: spmm_block_slabs(*args, f_tile=f_tile), 5):.3f} ms")
    log(f"K1 at f_tile=128 (default) {ms:.3f} ms; {', '.join(tiles)}; of "
        f"which zero-filling the output alone takes {zero_ms:.3f} ms")

    # torch.sparse.mm (cuSPARSE) on the same block-diagonal A and X
    rowptrs, cols, vals = [np.zeros(1, np.int64)], [], []
    for g, r0, c0 in zip(graphs.values(), out_off, col_off):
        rowptrs.append(g.rowptr[1:] + rowptrs[-1][-1])
        cols.append(g.colidx + c0)
        vals.append(g.values)
    a_csr = torch.sparse_csr_tensor(  # yardstick only, never on the path
        torch.from_numpy(np.concatenate(rowptrs)).to(dev),
        torch.from_numpy(np.concatenate(cols)).to(dev),
        torch.from_numpy(np.concatenate(vals)).to(dev), size=(n_out, n_x))
    lib = lambda: torch.sparse.mm(a_csr, x)            # noqa: E731
    lib_out = lib()
    perm_back = torch.cat([p.inv_perm + int(o) for p, o in
                           zip(plans, out_off[:-1])])
    lib_err = float((got[perm_back] - lib_out).abs().max())
    del lib_out
    lib()
    library_ms = cuda_ms(lib, 5)

    # hub row alone: the split blocks of Reddit's largest row, all adding
    # into one output row
    reddit = plans[0]
    bp = reddit.partition
    hub_row = int(bp.meta[bp.is_split][np.argmax(bp.meta[bp.is_split, 0]), 2])
    hub = np.flatnonzero(bp.is_split & (bp.meta[:, 2] == hub_row))
    hsl = {k: reddit.slabs[k][torch.from_numpy(hub).to(dev)].contiguous()
           for k in ("colidx", "values", "rowloc", "out_row")}
    hx = x[:reddit.n_cols]
    hub_args = (hsl["colidx"], hsl["values"], hsl["rowloc"], hsl["out_row"],
                hx, reddit.n_rows)
    spmm_block_slabs(*hub_args)
    hub_ms = cuda_ms(lambda: spmm_block_slabs(*hub_args), 10)
    # control: the same blocks, each writing a row of its own (no atomic
    # contention), isolates what the shared hub row costs
    spread = torch.full_like(hsl["out_row"], len(hub))
    spread[:, 0] = torch.arange(len(hub), device=dev, dtype=torch.int32)
    spread_args = hub_args[:3] + (spread, hx, len(hub))
    spmm_block_slabs(*spread_args)
    spread_ms = cuda_ms(lambda: spmm_block_slabs(*spread_args), 10)
    hub_bytes = len(hub) * reddit.slabs["C"] * F * 4
    log(f"hub row: {len(hub)} split blocks into one row at F={F}: K1 "
        f"{hub_ms:.3f} ms; the same blocks into {len(hub)} distinct rows "
        f"{spread_ms:.3f} ms (gathering the {len(hub) * reddit.slabs['C']} "
        f"slots without reuse would take {hub_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
        f" ms at the memory rate)")

    nnz = sum(g.nnz for g in graphs.values())
    slab_bytes = sum(merged[k].numel() * 4
                     for k in ("colidx", "values", "rowloc", "out_row"))
    moved = (n_x + n_out) * F * 4 + slab_bytes
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * nnz * F / FP32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"fused dispatch F={F}: {merged['colidx'].shape[0]} blocks "
        f"({b_live} live), n_x={n_x} n_out={n_out} nnz={nnz}; K1 {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms, torch.sparse.mm {library_ms:.3f} ms "
        f"(max |K1 - sparse.mm| {lib_err:.2e}); bound {bound_ms:.3f} ms "
        f"({moved / 1e9:.3f} GB moved, {bytes_ms:.3f} ms; "
        f"{2.0 * nnz * F / 1e9:.1f} GFLOP, {ops_ms:.3f} ms); K1 at "
        f"{bound_ms / ms * 100:.1f}% of the bound")
    return {"name": "spmm_block_slabs", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_accel.cu",
            "replaces": "src/repro/kernels/spmm_accel.py:73",
            "launches": launches, "max_abs_err": max(err, float_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms}


def main():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script "
                           "runs the port on a GPU")
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        raise RuntimeError(f"no repro_torch package under {SRC}")
    sys.path.insert(0, SRC)
    t0 = time.perf_counter()
    name, card_line = phase_card(torch)
    phase_build()
    dev = torch.device("cuda")
    float_err = phase_kernel_cases(torch, dev)
    graphs, engine, launches = phase_serve(torch, dev)
    phase_profile(torch, engine, graphs)
    engine.close()
    record = phase_timing(torch, graphs, engine, launches, float_err)
    log(f"total {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": [record]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # noqa: BLE001 — any failed phase fails the run
        import traceback
        traceback.print_exc()
        print(f"[chip_smoke] FAIL: {type(e).__name__}: {e}", file=sys.stderr)
        sys.exit(1)
