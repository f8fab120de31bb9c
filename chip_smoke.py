#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

K1 (``csrc/spmm_accel.cu``), K2 (``csrc/spmm_windowed.cu``) and K3
(``csrc/spmm_hbm.cu``) are one live-row gather pipeline
(``csrc/slab_common.cuh``): a CTA per (block, feature tile),
feature-tile-major over the grid, gathers one row segment per live slot
into a shared-memory ring (a bulk copy per segment on mbarriers where
F % 4 == 0 and X is 16-byte aligned, else 4-byte cp.async per thread), sums
each local row's run in registers and adds it into the output with one
fp32 RED; K1 and K3 launch the same kernel in slot order, K2 walks by
(local row, window, slot), adding window partials in window order.

Phases (any failure exits non-zero and prints no result line):

1. the card: name, power limit, torch and CUDA versions; TF32 is switched
   off for matmuls and cuDNN so every fp32 product is full fp32;
2. build K1, K2, K3 and K4 (``src/repro_torch/csrc/spmm_accel.cu``,
   ``spmm_windowed.cu``, ``spmm_hbm.cu``, ``grouped_matmul.cu``) with nvcc
   for sm_90a, all four at once, and print ptxas' registers, shared memory
   and spills, and each kernel's dynamic shared memory per CTA and the
   CTAs one SM holds per gather instance (K1 at every f_tile of its sweep,
   K2 and K3 at 128; more than 2 each);
3. each kernel against its plain PyTorch version on the card, in both
   partition modes: zero-degree rows, degree == deg_bound, degree > C
   (split rows), F in {1, 100, 2048}, and merged batched slabs with
   all-zero padding blocks, also from an X view 4 bytes off a 16-byte
   boundary; K1 at every f_tile its wrapper can pick; K2 at 1, 2 and 4 row
   windows, with window boundaries that cut blocks. Integer-valued graphs
   must match exactly. K2's window order is pinned by a row that sums to
   exactly 1 only in window order (0 in slot order), held bit for bit
   against the plain version on the CPU; both gather instances of K1, K2
   and K3 must have run;
4. slice A's path: the Reddit and Arxiv analogues registered in one
   GraphServeEngine (backend ``accel``, K1), the 25m GCN (dims
   1024-2048x4-256, 256 classes) served layer by layer for 2 rounds, then
   4 threads x 4 concurrent submits at width 256. Every answer is checked
   against the CSR oracle on the card. The K1 launch count of this phase
   must equal the number of dispatches, every launch through the ``bulk``
   gather instance;
5. where one served F=2048 layer spends its device time (torch.profiler);
6. slice B1's path, routed serving: GraphServeEngine(backend="auto") serves
   the same GCN for 2 rounds over the Reddit and Arxiv analogues fused into
   one dispatch per layer (hbm -> K3), the ``25m`` preset's own graph alone
   (windowed, 2 windows -> K2) and the ``tiny`` preset's graph alone
   (resident -> K1). Every answer is checked against the CSR oracle; the
   K1/K2/K3 launch counts of the phase must equal the engines' routed
   counts (12/12/12), each at least 1, and every K1, K2 and K3 launch of
   the phase must have taken the ``bulk`` gather instance;
   backend="pallas" on Reddit must raise VmemBudgetError;
7. kernel times (CUDA events), in turns on one card: K1, K3, K1 again, the
   plain version and ``torch.sparse.mm`` on the same A and X (a yardstick
   the port never calls) per fused Reddit+Arxiv dispatch at F=2048; K1's
   column-slice sweep (f_tile 32 to 512 in both gather instances) in turns
   with K3 and ``torch.sparse.mm``, each first held against the plain
   version; the hub
   row; K1 in its routed regime (the ``tiny`` graph and a 4,096-node
   power-law graph at F=2048) beside ``torch.sparse.mm``; K2,
   ``torch.sparse.mm``, K2 again and the plain version on the 25m graph at
   F=2048. Each beside the memory bound and its rate of needed gather bytes
   (nnz * F * 4 / ms);
8. slice D's training path: the ``100m`` preset of
   ``examples/train_gcn.py`` (5,000 nodes, dims 1024-4096x7-256, 256
   classes, 9 layers, ~106M fp32 parameters, from seed 0) built through
   ``repro_torch.examples.train_gcn.build_problem`` with ``GraphOp`` on K1
   (``backend="accel"``). Step 0's loss and every gradient against the
   twin (``backend="blocked"``) from the same parameters, within
   ``grad_bound_rel``; one backward aggregation ``bwd(g)`` at F=4096
   against the fp64 CSR oracle of A'^T within the
   summation bound; then 5 SGD steps (lr 1e-2) through the trainer's
   ``train`` loop: losses finite and falling, K1 launched 18 times per step
   (9 on the A' plan, 9 on the A'^T plan); the median step time by CUDA
   events, K1's share of a step's device time by torch.profiler, peak
   memory; a checkpoint of the final parameters restored bit for bit with
   the same loss; ``sage`` and ``gin`` at the ``tiny`` preset against the
   twin;
9. slice D's mutation path: the Arxiv analogue (169,343 nodes, ~1.34M nnz
   after gcn_normalize) in a ``GraphServeEngine`` of backend ``accel`` (K1)
   and one of backend ``auto`` (K3 at F=2048), served at F=2048, then 4
   ``mutate()`` deltas of 250 inserts and 250 deletes each while 2 threads
   submit reads. Every read equals the CSR oracle of one published version
   (pre- or post-delta), every delta is repaired (no rebuild), and the final
   version's answer equals a fresh ``build_partition_plan`` of the
   post-delta graph through the same kernel within twice the summation
   bound; an integer-valued copy (values 1-3, features -4..4) holds all of
   it exactly. A second integer chain draws its deletes uniformly over
   the edges, so they land on the hub rows and the fragmentation guard may
   rebuild: its reads and final version are held exactly as above, and
   each delta's repaired/rebuilt outcome is logged, not asserted. The
   phase's K1 and K3 launches must equal the engines' dispatches. Then the repair of one delta against a fresh build on the
   host clock, and the served latency before and after;
10. K4, the grouped GEMM, against its plain version on edge cases, each
   case asserting which of K4's two instances ran it. The CUDA-core
   (``simt``) instance: an expert with no rows, a single expert, trailing
   clipped blocks, m_tile 8/16/128/160, K and N not multiples of 4, fp32
   and bf16 x and w in every combination. The tensor-core (``wgmma``)
   instance, bf16 x and w: the same block structures at m_tile
   64/128/192/256, K 512 and 520, N 256 and 264, and NaN/Inf in the weights
   of the experts beside the one multiplied. Integer inputs exact, float
   inputs within ``(K+1) * 2**-24 * (|x| @ |w|)`` of the fp64 product.
   Then ``wgmma`` exact on integers at dbrx-132b's full wi and wo widths,
   at 144 and 20 row blocks (the two token counts of phase 11);
11. slice C1's path: ``moe_block`` at dbrx-132b's full width (d_model 6144,
   d_ff 10752, 16 experts, top-4) through K4, weights from ``init_moe``
   (router fp32, experts bf16): {4,096 tokens, 128 tokens} x {balanced,
   skewed} routing and one fp32 run. K4 launches: 3 per call, the 12 of
   the bf16 calls through ``wgmma``, the fp32 call's 3 through ``simt``.
   In each case the three products (wi, wg, wo), rebuilt from the
   dispatch, are each held against the plain version on the same operands
   (``k4_pair_check``), and the outputs of K4's path and of the twin
   against an fp64 oracle on a sample of 256 tokens (bound in
   ``moe_oracle``);
12. K4 times at 4,096 tokens (each GEMM in bf16 through ``wgmma``, wi
   through ``simt`` on the same bf16 operands and with fp32 operands, the
   plain version, ``torch._grouped_mm`` as the library yardstick) and at 128
   tokens (each GEMM, bound by the weights' bytes), each beside its bound,
   and the whole ``moe_block`` at both; then the ``{"kernels": [...]}``
   line (K1's and K3's records also carry ``launches_by_path``, their
   launches on each path that runs them), the card line, and the
   ``{"ok": true, ...}`` line last.

Tolerance for float results. K1 and K3 sum a row in two levels: at most
min(deg, C) rounded products in order inside a block, then one partial per
block (ceil(deg / C) of them) in any order. The classic bound for recursive
summation gives, per element, ``|y - exact| <= k * u * (|A| @ |x|)`` with
``k = min(deg, C) + ceil(deg/C) + 1`` and ``u = 2**-24``. K2 adds one level,
the window partials of each block row, so its k grows by the number of
windows. Served answers are held to that bound against an fp64 CSR oracle;
a kernel and its plain version, both fp32, to twice it.
"""
import gc
import json
import math
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
BF16_FLOPS = 989.4e12         # H100 SXM dense bf16 tensor-core rate
DIMS = [1024, 2048, 2048, 2048, 2048, 256]   # examples/train_gcn.py "25m"
N_CLASSES = 256
GRAPHS = ("Reddit", "Arxiv")
# examples/train_gcn.py presets: (name, nodes, edges) of their own graphs
PRESET_GRAPHS = (("25m", 8_000, 64_000), ("tiny", 2_000, 12_000))
K1_SWEEP = (32, 64, 128, 256, 512)   # K1's column slices timed in phase 7


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
    """Build every kernel library at once and print, per kernel, what ptxas
    reports (registers, spills, static shared memory) and, at C=256, R=64,
    its dynamic shared memory per CTA and the CTAs one SM holds for each
    gather instance: K1 at every f_tile of the phase 7 sweep, K2 and K3 at
    f_tile=128. Fails where a pipeline CTA that the wrappers launch leaves
    2 or fewer CTAs per SM."""
    from repro_torch.kernels import spmm_accel, spmm_hbm
    from repro_torch.kernels.build import build_all, load_kernel
    t0 = time.perf_counter()
    built = build_all()
    log(f"K1, K2, K3, K4 built in parallel in "
        f"{time.perf_counter() - t0:.1f}s")
    for name, (path, report) in built.items():
        log(f"{name}: {os.path.relpath(path, ROOT)}")
        for line in report.splitlines():
            if any(k in line for k in ("registers", "spill", "smem",
                                       "Compiling", "warning")):
                log(f"ptxas: {line.strip()}")
    C, R = 256, 64
    k1 = load_kernel("spmm_accel", spmm_accel._declare_k1)
    for kern, lib, prefix, f_tiles in (
            ("K1", k1, "spmm_block_slabs", K1_SWEEP),
            ("K2", load_kernel("spmm_windowed", spmm_accel._declare_k2),
             "spmm_windowed", (128,)),
            ("K3", load_kernel("spmm_hbm", spmm_hbm._declare), "spmm_hbm",
             (128,))):
        for f_tile in f_tiles:
            smem = getattr(lib, f"{prefix}_smem_bytes")(C, R, f_tile)
            ctas = {inst: getattr(lib, f"{prefix}_ctas_per_sm")(
                        C, R, f_tile, int(inst == "bulk"))
                    for inst in spmm_accel.GATHER_INSTANCES}
            log(f"{kern} at C={C}, R={R}, f_tile={f_tile}: {smem} B of "
                f"dynamic shared memory per CTA (no [R, f_tile] tile); CTAs "
                f"per SM: " + ", ".join(f"{i} {n}" for i, n in ctas.items()))
            if min(ctas.values()) <= 2:
                raise AssertionError(f"{kern} f_tile={f_tile}: {ctas} CTAs "
                                     f"per SM")
    log("K4: its source's fixed ring (kSmemBytes, 197,696 B) allows one "
        "CTA per SM")


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


def k1_tiles():
    """Every f_tile K1's wrapper can pick: its default and 32, 64, 128."""
    from repro_torch.kernels.spmm_accel import K1_F_TILE
    return sorted({32, 64, 128, K1_F_TILE})


def k1_c_launch(torch, instance, f_tile, colidx, values, rowloc, out_row,
                x, n_rows):
    """K1 through its C interface in the given gather instance, on the
    current stream. Not counted: only the wrapper counts launches."""
    from repro_torch.kernels import spmm_accel
    from repro_torch.kernels.build import load_kernel
    lib = load_kernel("spmm_accel", spmm_accel._declare_k1)
    B, C = colidx.shape
    R = out_row.shape[1]
    F = x.shape[1]
    out = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    if B == 0 or F == 0 or n_rows == 0:
        return out
    ptrs = (colidx.data_ptr(), values.data_ptr(), rowloc.data_ptr(),
            out_row.data_ptr(), x.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.spmm_block_slabs_launch(*ptrs, B, C, R, F, n_rows, f_tile,
                                      int(instance == "bulk"), stream)
    if err:
        raise RuntimeError(f"K1 {instance} launch failed: "
                           f"{lib.slab_kernel_error_string(err).decode()}")
    return out


def kernel_variants(torch, n_x):
    """(kernel, label, launch, plain version, extra summation levels) for
    a feature operand of n_x rows: K1 at every f_tile its wrapper can pick,
    K3, and K2 at 1, 2 and 4 windows."""
    from functools import partial
    from repro_torch.kernels.spmm_accel import (
        spmm_block_slabs, spmm_block_slabs_plain, spmm_block_slabs_windowed,
        spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_hbm import (spmm_block_slabs_hbm,
                                              spmm_block_slabs_hbm_plain)
    out = [("K1", f"K1 f_tile={t}", partial(spmm_block_slabs, f_tile=t),
            spmm_block_slabs_plain, 0) for t in k1_tiles()]
    out.append(("K3", "K3", spmm_block_slabs_hbm, spmm_block_slabs_hbm_plain,
                0))
    for nw in (1, 2, 4):
        window = -(-n_x // nw)
        if -(-n_x // window) != nw:
            raise AssertionError(f"{n_x} rows do not split into {nw} windows")

        def k2(*args, window=window):
            return spmm_block_slabs_windowed(*args, window_rows=window)

        def k2_plain(*args, window=window):
            return spmm_block_slabs_windowed_plain(*args, window)
        out.append(("K2", f"K2 {nw} window(s) of {window}", k2, k2_plain,
                    nw))
    return out


def windows_cutting_blocks(torch, slabs, window):
    """Blocks whose live slots fall in more than one row window."""
    live = slabs["values"] != 0
    w = slabs["colidx"].long() // window
    lo = w.masked_fill(~live, 1 << 40).min(dim=1).values
    hi = w.masked_fill(~live, -1).max(dim=1).values
    return int((live.any(dim=1) & (lo != hi)).sum())


def order_pinning_case(torch, dev, F):
    """One block whose single row sums +1 (window 1), +2**24 (window 0) and
    -2**24 (window 1), each times x = 1, with 4-row windows over 8 rows.
    Window partials added in window order give exactly 1; the slots summed
    in slot order give 0. Returns the kernel arguments and the window."""
    colidx = torch.tensor([[5, 1, 6, 0]], dtype=torch.int32, device=dev)
    values = torch.tensor([[1.0, 2.0 ** 24, -2.0 ** 24, 0.0]], device=dev)
    rowloc = torch.zeros((1, 4), dtype=torch.int32, device=dev)
    out_row = torch.zeros((1, 1), dtype=torch.int32, device=dev)
    return (colidx, values, rowloc, out_row,
            torch.ones((8, F), device=dev), 1), 4


def phase_kernel_cases(torch, dev):
    """K1, K2 and K3 against their plain versions on ``dev``; returns each
    kernel's max abs error over the float cases."""
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.spmm_accel import (
        spmm_block_slabs, spmm_block_slabs_plain, spmm_block_slabs_windowed,
        spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm

    gen = torch.Generator(device=dev).manual_seed(7)
    worst = {"K1": 0.0, "K2": 0.0, "K3": 0.0}
    n_cases = 0

    def run(label, slabs, n_rows, x, exact, k=None):
        nonlocal n_cases
        args = (slabs["colidx"], slabs["values"], slabs["rowloc"],
                slabs["out_row"])
        mag = None
        for kern, name, fn, plain, levels in kernel_variants(torch,
                                                            x.shape[0]):
            got = fn(*args, x, n_rows)
            want = plain(*args, x, n_rows)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            if exact:
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"{label}: {name} differs from its plain version on "
                        f"an integer-valued graph")
            else:
                if mag is None:
                    mag = spmm_block_slabs_plain(
                        args[0], args[1].abs(), args[2], args[3], x.abs(),
                        n_rows).double()
                kt = torch.as_tensor(k + levels, dtype=torch.float64,
                                     device=x.device)[:, None]
                worst[kern] = max(worst[kern], check_close(
                    f"{label} {name}", got, want, 2 * U * kt * mag))
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
        cut = {nw: (windows_cutting_blocks(torch, p_int.slabs,
                                           -(-g_int.n_cols // nw)),
                    windows_cutting_blocks(torch, p_norm.slabs,
                                           -(-g_norm.n_cols // nw)))
               for nw in (2, 4)}
        if any(min(c) == 0 for c in cut.values()):
            raise AssertionError(f"{mode}: no window boundary cuts a block")
        for F in (1, 100, 2048):
            xi = torch.randint(-4, 5, (g_int.n_cols, F), generator=gen,
                               device=dev).float()
            run(f"{mode} int F={F}", p_int.slabs, g_int.n_rows, xi, True)
            xf = torch.randn((g_norm.n_cols, F), generator=gen, device=dev)
            run(f"{mode} normalized F={F}", p_norm.slabs, g_norm.n_rows, xf,
                False, summation_k(g_norm, cfg.deg_bound, True))
        log(f"K1, K2, K3 == plain: {mode} mode C={cfg.deg_bound} "
            f"R={p_int.slabs['R']}, {p_int.num_blocks} blocks ({split} "
            f"split); blocks cut by a window boundary (int, normalized): "
            f"{cut[2]} at 2 windows, {cut[4]} at 4")

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
    # a view 4 bytes past a 16-byte boundary: K1, K2 and K3 take cp_async
    xu = torch.empty(n_x * 2048 + 1, device=dev)[1:].view(n_x, 2048)
    xu.copy_(xi)
    run("merged F=2048, unaligned x", merged, n_out, xu, True)
    log(f"K1, K2, K3 == plain: merged C={merged['C']} R={merged['R']}, "
        f"{b_total} live + {merged['colidx'].shape[0] - b_total} padding "
        f"blocks")
    for F in (1, 100, 2048):
        pin, window = order_pinning_case(torch, dev, F)
        got = spmm_block_slabs_windowed(*pin, window_rows=window).cpu()
        want = spmm_block_slabs_windowed_plain(
            *[a.cpu() if torch.is_tensor(a) else a for a in pin], window)
        if not (torch.equal(got, want) and bool((want == 1.0).all())):
            raise AssertionError(f"K2 order pinning F={F}: got "
                                 f"{got[0, :4].tolist()}, plain on the CPU "
                                 f"{want[0, :4].tolist()} (window order: 1)")
    by_instance = {k: dict(fn.launches_by_instance) for k, fn in
                   (("K1", spmm_block_slabs),
                    ("K2", spmm_block_slabs_windowed),
                    ("K3", spmm_block_slabs_hbm))}
    log(f"K2 window order pinned (exactly 1.0 at F=1, 100, 2048); gather "
        f"instances launched: {by_instance}")
    if dev.type == "cuda" and min(n for c in by_instance.values()
                                  for n in c.values()) < 1:
        raise AssertionError(f"a gather instance never ran: {by_instance}")
    log(f"phase 3 ok: {n_cases} cases, integer cases exact, float max "
        f"|kernel - plain|: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in worst.items()))
    return worst


def csr_oracle(torch, g, x, nnz_chunk, magnitude=False):
    """A'.x in fp64 by the plain CSR product on ``x``'s device (exact for
    small integer values); with ``magnitude``, |A'|.|x|, the scale of the
    summation bounds. The one oracle of the GCN phases."""
    import numpy as np
    from repro_torch.kernels.ref import csr_spmm_ref
    vals = g.values.astype(np.float64)
    if magnitude:
        vals, x = np.abs(vals), x.abs()
    return csr_spmm_ref(g.rowptr, g.colidx, vals, x.double(),
                        nnz_chunk=nnz_chunk)


def csr_check(torch, g, x, y, C, nnz_chunk, extra_levels=0):
    """Hold ``y`` (original row order) against the fp64 CSR oracle for A'.x,
    within the summation bound of the kernel's fp32 sums (``extra_levels``:
    K2's window partials)."""
    want = csr_oracle(torch, g, x, nnz_chunk)
    mag = csr_oracle(torch, g, x, nnz_chunk, magnitude=True)
    k = torch.as_tensor(summation_k(g, C, False) + extra_levels,
                        dtype=torch.float64, device=x.device)[:, None]
    return check_close("served", y, want, U * k * mag)


def phase_serve(torch, dev):
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_benchmark_graph
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
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
    spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
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
    by_instance = dict(spmm_block_slabs.launches_by_instance)
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
    # every fused X is a fresh contiguous tensor of width % 4 == 0
    log(f"K1 launches by gather instance: {by_instance}")
    if by_instance != {"bulk": launches, "cp_async": 0}:
        raise AssertionError(f"K1's launches by instance {by_instance}: "
                             f"expected all {launches} bulk")
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


def phase_routed(torch, dev, graphs, cache):
    """Slice B1's main path: GraphServeEngine(backend="auto") routing each
    fused dispatch to K1, K2 or K3. Returns the small graphs, the engine
    that served them and the launch count of each kernel."""
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.router import VmemBudgetError
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs,
                                                spmm_block_slabs_windowed)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.models.layers import dense_init
    from repro_torch.serve.graph_engine import GraphRequest, GraphServeEngine

    small = {}
    for name, n, e in PRESET_GRAPHS:
        small[name] = gcn_normalize(make_power_law_graph(n, e, seed=0))
    # the large graphs fuse into one dispatch; each small graph dispatches
    # alone, so fusing cannot move it to another regime
    big_engine = GraphServeEngine(device=dev, backend="auto", cache=cache,
                                  max_graphs_per_batch=2)
    small_engine = GraphServeEngine(device=dev, backend="auto",
                                    max_graphs_per_batch=1)
    for name, g in graphs.items():
        big_engine.register_graph(name, g)
    for name, g in small.items():
        plan = small_engine.register_graph(name, g)
        log(f"{name} preset graph: {g.n_rows} nodes, {g.nnz} nnz after "
            f"gcn_normalize, {plan.num_blocks} blocks "
            f"({int(plan.partition.is_split.sum())} split)")
    every = dict(graphs, **small)
    expect = {name: "hbm" for name in graphs}
    expect.update({"25m": "windowed", "tiny": "resident"})

    gen = torch.Generator().manual_seed(0)
    dims = DIMS + [N_CLASSES]
    weights = [dense_init(gen, a, b, torch.float32, device=dev)
               for a, b in zip(dims[:-1], dims[1:])]
    dgen = torch.Generator(device=dev).manual_seed(5)
    feats = {name: torch.randn((g.n_rows, dims[0]), generator=dgen,
                               device=dev) for name, g in every.items()}
    nnz_chunk = 1 << 17
    C = big_engine.config.deg_bound
    kernels = {"K1": spmm_block_slabs, "K2": spmm_block_slabs_windowed,
               "K3": spmm_block_slabs_hbm}

    for fn in kernels.values():            # main path starts here
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_main = time.perf_counter()
    for rnd in range(2):
        h = dict(feats)
        for li, w in enumerate(weights):
            xw = {name: h[name] @ w for name in every}
            served = big_engine.serve([GraphRequest(name, xw[name])
                                       for name in graphs])
            decisions = {name: big_engine.last_decision for name in graphs}
            for name in small:
                served += small_engine.serve([GraphRequest(name, xw[name])])
                decisions[name] = small_engine.last_decision
            errs = []
            for r in served:
                d = decisions[r.graph_id]
                if d.backend != expect[r.graph_id]:
                    raise AssertionError(f"{r.graph_id} routed to "
                                         f"{d.backend}: {d.describe()}")
                extra = d.num_windows if d.backend == "windowed" else 0
                errs.append(csr_check(torch, every[r.graph_id],
                                      xw[r.graph_id], r.out, C, nnz_chunk,
                                      extra))
                h[r.graph_id] = (torch.relu(r.out) if li < len(weights) - 1
                                 else r.out)
            if rnd == 0 and li == 0:
                for name in ("Reddit", "25m", "tiny"):
                    log(f"route {name}: {decisions[name].describe()}")
            log(f"routed round {rnd} layer {li} F={w.shape[1]}: max err "
                f"{max(errs):.2e}; latency "
                + ", ".join(f"{r.graph_id} {r.latency_s * 1e3:.1f}ms"
                            for r in served))
        for name, g in every.items():
            if not bool(torch.isfinite(h[name]).all()) or \
                    tuple(h[name].shape) != (g.n_rows, N_CLASSES):
                raise AssertionError(f"{name}: logits not finite or of shape "
                                     f"{tuple(h[name].shape)}")
    t_main = time.perf_counter() - t_main
    launches = {k: fn.launches for k, fn in kernels.items()}  # path ends
    by_instance = {k: dict(fn.launches_by_instance)
                   for k, fn in kernels.items()}
    big, sm = big_engine.stats(), small_engine.stats()
    routed = {"K1": big["routed_resident"] + sm["routed_resident"],
              "K2": big["routed_windowed"] + sm["routed_windowed"],
              "K3": big["routed_hbm"] + sm["routed_hbm"]}
    log(f"routed path: launches {launches}, engines' routed counts "
        f"{routed}; dispatches {big['batches_dispatched']} + "
        f"{sm['batches_dispatched']}; {t_main:.1f}s including the oracle "
        f"checks")
    if launches != routed or min(launches.values()) < 1:
        raise AssertionError(f"kernel launches {launches} differ from the "
                             f"routed dispatches {routed}")
    # every routed X is a fresh contiguous product of width % 4 == 0, so
    # every K1, K2 and K3 launch of the path must be bulk
    log(f"routed path: launches by gather instance {by_instance}")
    for k, counts in by_instance.items():
        if counts != {"bulk": launches[k], "cp_async": 0}:
            raise AssertionError(f"{k}'s routed launches by instance "
                                 f"{counts}: expected all {launches[k]} "
                                 f"bulk")
    big_engine.close()

    forced = GraphServeEngine(device=dev, backend="pallas", cache=cache)
    forced.register_graph("Reddit", graphs["Reddit"])
    try:
        forced.serve_one("Reddit", feats["Reddit"][:, :8].contiguous())
    except VmemBudgetError as e:
        log(f"backend='pallas' on Reddit raised VmemBudgetError: "
            f"{str(e)[:120]}...")
    else:
        raise AssertionError("backend='pallas' on Reddit did not raise "
                             "VmemBudgetError")
    finally:
        forced.close()
    return small, small_engine, launches


def sparse_csr(torch, graphs, col_offsets, n_out, n_x, dev):
    """torch.sparse CSR tensor of the block-diagonal A of ``graphs`` (a
    yardstick only, never on the port's path)."""
    import numpy as np
    rowptrs, cols, vals = [np.zeros(1, np.int64)], [], []
    for g, c0 in zip(graphs, col_offsets):
        rowptrs.append(g.rowptr[1:] + rowptrs[-1][-1])
        cols.append(g.colidx + c0)
        vals.append(g.values)
    return torch.sparse_csr_tensor(
        torch.from_numpy(np.concatenate(rowptrs)).to(dev),
        torch.from_numpy(np.concatenate(cols)).to(dev),
        torch.from_numpy(np.concatenate(vals)).to(dev), size=(n_out, n_x))


def bound_of(n_x, n_out, F, slabs, nnz):
    """The least time the card could take, from bytes and operations."""
    slab_bytes = sum(slabs[k].numel() * 4
                     for k in ("colidx", "values", "rowloc", "out_row"))
    moved = (n_x + n_out) * F * 4 + slab_bytes
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * nnz * F / FP32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", moved, bytes_ms,
            ops_ms)


def phase_timing_k2(torch, small, engine, launches, float_err):
    """K2 on the 25m preset's graph at F=2048 (2 windows), against its plain
    version, the library SpMM and the memory bound; K3 on the same slabs
    (one window: no sort) shows what K2's window order costs."""
    from repro_torch.kernels.router import route_spmm
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs_plain,
                                                spmm_block_slabs_windowed,
                                                spmm_block_slabs_windowed_plain)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    dev = torch.device("cuda")
    F = 2048
    g = small["25m"]
    plan = engine.plan_for("25m")
    s = plan.slabs
    d = route_spmm(g.n_cols, F, int(s["C"]), int(s["R"]))
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((g.n_cols, F), generator=gen, device=dev)
    args = (s["colidx"], s["values"], s["rowloc"], s["out_row"], x,
            plan.n_rows)
    k2 = lambda: spmm_block_slabs_windowed(*args)     # noqa: E731
    plain = lambda: spmm_block_slabs_windowed_plain(  # noqa: E731
        *args, d.window_rows)
    got, want = k2(), plain()
    mag = spmm_block_slabs_plain(args[0], args[1].abs(), args[2], args[3],
                                 x.abs(), plan.n_rows).double()
    k = summation_k(g, int(s["C"]), True) + d.num_windows
    kt = torch.as_tensor(k, dtype=torch.float64, device=dev)[:, None]
    err = check_close("25m F=2048 K2 vs plain", got, want, 2 * U * kt * mag)
    del mag, want
    a_csr = sparse_csr(torch, [g], [0], plan.n_rows, g.n_cols, dev)
    lib = lambda: torch.sparse.mm(a_csr, x)           # noqa: E731
    lib_err = float((got[plan.inv_perm] - lib()).abs().max())
    k2()
    lib()
    ms = cuda_ms(k2, 10)                 # K2 and sparse.mm in turns
    library_ms = cuda_ms(lib, 10)
    ms_again = cuda_ms(k2, 10)
    plain_ms = cuda_ms(plain, 3)
    k3 = lambda: spmm_block_slabs_hbm(*args)          # noqa: E731
    k3()
    k3_ms = cuda_ms(k3, 10)
    bound_ms, bound_by, moved, bytes_ms, ops_ms = bound_of(
        g.n_cols, plan.n_rows, F, s, g.nnz)
    log(f"K2 25m graph F={F}: {plan.num_blocks} blocks, {d.num_windows} "
        f"windows of {d.window_rows}, n={g.n_rows} nnz={g.nnz}; K2 "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, torch.sparse.mm "
        f"{library_ms:.3f} ms (max |K2 - sparse.mm| {lib_err:.2e}); bound "
        f"{bound_ms:.3f} ms ({moved / 1e9:.4f} GB, {bytes_ms:.3f} ms; "
        f"{2.0 * g.nnz * F / 1e9:.2f} GFLOP, {ops_ms:.3f} ms)")
    log(f"K2 25m graph F={F}, needed gather {g.nnz * F * 4 / 1e9:.3f} GB: "
        + "; ".join(f"{name} {t:.3f} ms, gather "
                    f"{gather_rate(g.nnz, F, t):.2f} TB/s, "
                    f"{bound_ms / t * 100:.2f}% of the bound"
                    for name, t in (("K2", ms), ("torch.sparse.mm",
                                                 library_ms),
                                    ("K2 again", ms_again),
                                    ("K3 on the same slabs", k3_ms))))
    return {"name": "spmm_block_slabs_windowed", "route": "cuda",
            "source": "src/repro_torch/csrc/spmm_windowed.cu",
            "replaces": "src/repro/kernels/spmm_accel.py:180",
            "launches": launches["K2"], "max_abs_err": max(err, float_err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def gather_rate(nnz, F, ms):
    """TB/s of the gather a slab SpMM needs: one F-wide fp32 row segment
    per non-zero (nnz * F * 4 bytes), whatever L2 serves of it."""
    return nnz * F * 4 / (ms * 1e-3) / 1e12


def fused_dispatch(torch, plans, F):
    """The engine's fused dispatch of ``plans`` (merged slabs padded to the
    block bucket) with random features of width F: (merged slabs, output
    and column offsets, n_out, kernel arguments)."""
    from repro_torch.kernels.spmm_batched import batch_graph_slabs, bucket_blocks
    merged, out_off, col_off, n_out = batch_graph_slabs(
        [p.slabs for p in plans], [p.n_rows for p in plans],
        [p.n_cols for p in plans],
        pad_blocks_to=bucket_blocks(sum(p.num_blocks for p in plans)))
    dev = merged["colidx"].device
    gen = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((int(col_off[-1]), F), generator=gen, device=dev)
    return merged, out_off, col_off, n_out, (
        merged["colidx"], merged["values"], merged["rowloc"],
        merged["out_row"], x, n_out)


def k1_sweep_configs(torch, args):
    """K1 in each gather instance at each f_tile of ``K1_SWEEP``, through
    the C interface on ``args``."""
    from functools import partial
    from repro_torch.kernels.spmm_accel import GATHER_INSTANCES
    return {f"K1 {inst} f_tile={t}": partial(k1_c_launch, torch, inst, t,
                                             *args)
            for t in K1_SWEEP for inst in GATHER_INSTANCES}


def timed_in_turns(fns, reps, timer, rounds=2):
    """Each callable timed ``rounds`` times, in turns: ms per call."""
    ms = {label: [] for label in fns}
    for _ in range(rounds):
        for label, fn in fns.items():
            fn()
            ms[label].append(timer(fn, reps))
    return ms


def phase_timing(torch, graphs, engine, launches, float_err):
    """K1 and K3 at the fused F=2048 Reddit+Arxiv dispatch shape against
    their plain version (the same function), the library SpMM and the
    memory bound, timed in turns on one card: K1, K3, K1 again, the plain
    version, torch.sparse.mm; then K1's column-slice sweep (each f_tile of
    ``K1_SWEEP`` in both gather instances) in turns with K3 and
    torch.sparse.mm, each checked against the plain version first.
    ``launches`` and ``float_err`` are per kernel. Returns the two kernel
    records."""
    import numpy as np
    from repro_torch.kernels.spmm_accel import (K1_F_TILE, spmm_block_slabs,
                                                spmm_block_slabs_plain)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm

    dev = torch.device("cuda")
    F = 2048
    plans = [engine.plan_for(name) for name in graphs]
    b_live = sum(p.num_blocks for p in plans)
    merged, out_off, col_off, n_out, args = fused_dispatch(torch, plans, F)
    n_x = int(col_off[-1])
    x = args[4]

    k1 = lambda: spmm_block_slabs(*args)               # noqa: E731
    k3 = lambda: spmm_block_slabs_hbm(*args)           # noqa: E731
    plain = lambda: spmm_block_slabs_plain(*args)      # noqa: E731
    want = plain()
    k = np.concatenate([summation_k(g, int(merged["C"]), True)
                        for g in graphs.values()])
    bound = pair_bound(torch, spmm_block_slabs_plain, args[:4], x, n_out, k)
    got = k1()
    err = {"K1": check_close("fused F=2048 K1 vs plain", got, want, bound)}
    got3 = k3()
    err["K3"] = check_close("fused F=2048 K3 vs plain", got3, want, bound)
    del got3
    sweep_fns = k1_sweep_configs(torch, args)
    sweep_err = {label: check_close(f"fused F=2048 {label} vs plain", fn(),
                                    want, bound)
                 for label, fn in sweep_fns.items()}
    del bound, want
    log("fused F=2048 sweep configs within the pair bound of plain, max "
        "|err|: " + ", ".join(f"{k} {v:.2e}" for k, v in sweep_err.items()))
    a_csr = sparse_csr(torch, graphs.values(), col_off, n_out, n_x, dev)
    lib = lambda: torch.sparse.mm(a_csr, x)            # noqa: E731
    lib_out = lib()
    perm_back = torch.cat([p.inv_perm + int(o) for p, o in
                           zip(plans, out_off[:-1])])
    lib_err = float((got[perm_back] - lib_out).abs().max())
    del lib_out
    for _ in range(2):
        k1()
        k3()
    lib()
    ms = {"K1": cuda_ms(k1, 10), "K3": cuda_ms(k3, 10)}
    ms["K1 again"] = cuda_ms(k1, 10)     # K1 and K3 in turns, one card
    plain_ms = cuda_ms(plain, 2)
    library_ms = cuda_ms(lib, 5)
    zero_ms = cuda_ms(lambda: torch.zeros((n_out, F), device=dev), 10)

    nnz = sum(g.nnz for g in graphs.values())
    bound_ms, bound_by, moved, bytes_ms, ops_ms = bound_of(
        n_x, n_out, F, merged, nnz)
    slab_pass = sum(merged[k].numel() * 4
                    for k in ("colidx", "values", "rowloc", "out_row"))
    turns = dict(sweep_fns, **{"K3": k3, "torch.sparse.mm": lib})
    sweep = timed_in_turns(turns, 5, cuda_ms)
    log(f"K1 column-slice sweep, fused dispatch F={F}, in turns (2 rounds "
        f"of 5 calls; ms per call; X slice = n_x x f_tile x 4 B, L2 50 MB; "
        f"slabs read once per slice, {slab_pass / 1e6:.1f} MB a pass):")
    for label, ts in sweep.items():
        f_tile = int(label.rsplit("=", 1)[1]) if "f_tile=" in label else None
        extra = (f"; X slice {n_x * f_tile * 4 / 1e6:.1f} MB, slabs "
                 f"{-(-F // f_tile) * slab_pass / 1e9:.2f} GB"
                 if f_tile else "")
        log(f"sweep {label}: {ts[0]:.3f} / {ts[1]:.3f} ms, gather "
            f"{gather_rate(nnz, F, min(ts)):.2f} TB/s, "
            f"{bound_ms / min(ts) * 100:.2f}% of the bound{extra}")
    log(f"K1 at f_tile={K1_F_TILE} (default) {ms['K1']:.3f} ms; "
        f"of which zero-filling the output alone takes {zero_ms:.3f} ms")

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

    log(f"fused dispatch F={F}: {merged['colidx'].shape[0]} blocks "
        f"({b_live} live), n_x={n_x} n_out={n_out} nnz={nnz}; K1 "
        f"{ms['K1']:.3f} ms (again {ms['K1 again']:.3f}), K3 {ms['K3']:.3f} "
        f"ms, plain {plain_ms:.3f} ms, torch.sparse.mm {library_ms:.3f} ms "
        f"(max |K1 - sparse.mm| {lib_err:.2e}); bound {bound_ms:.3f} ms "
        f"({moved / 1e9:.3f} GB moved, {bytes_ms:.3f} ms; "
        f"{2.0 * nnz * F / 1e9:.1f} GFLOP, {ops_ms:.3f} ms)")
    log(f"fused dispatch F={F}, needed gather {nnz * F * 4 / 1e9:.1f} GB "
        f"(nnz x F x 4): " + "; ".join(
            f"{name} {t:.3f} ms, gather {gather_rate(nnz, F, t):.2f} TB/s, "
            f"{bound_ms / t * 100:.2f}% of the bound"
            for name, t in (("K1", ms["K1"]), ("K3", ms["K3"]),
                            ("K1 again", ms["K1 again"]),
                            ("torch.sparse.mm", library_ms))))
    records = []
    for kern, name, source, replaces in (
            ("K1", "spmm_block_slabs", "src/repro_torch/csrc/spmm_accel.cu",
             "src/repro/kernels/spmm_accel.py:73"),
            ("K3", "spmm_block_slabs_hbm", "src/repro_torch/csrc/spmm_hbm.cu",
             "src/repro/kernels/spmm_hbm.py:48")):
        records.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kern],
            "max_abs_err": max(err[kern], float_err[kern]),
            "ms": ms[kern], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    return records


def device_ms(fn, reps):
    """Like ``cuda_ms``, for calls shorter than their host overhead: the
    card is held busy while the calls are queued, so the events time the
    calls back to back on the card."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)         # ~10 ms of clock cycles
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing_resident(torch, small, engine):
    """K1 in the regime ``auto`` routes to it (N_pad <= 4096 at fp32, X
    within L2) at F=2048: the ``tiny`` preset's graph and a 4,096-node
    power-law graph, K1 at its default and in the sweep's configurations
    against torch.sparse.mm on the same A and X, in turns."""
    import numpy as np
    from repro_torch.core.graph import gcn_normalize
    from repro_torch.core.plan_cache import PartitionConfig, build_partition_plan
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.kernels.router import route_spmm
    from repro_torch.kernels.spmm_accel import (spmm_block_slabs,
                                                spmm_block_slabs_plain)
    dev = torch.device("cuda")
    F = 2048
    g4 = gcn_normalize(make_power_law_graph(4096, 32768, seed=6))
    cases = {"tiny": (small["tiny"], engine.plan_for("tiny")),
             "power-law 4096": (g4, build_partition_plan(
                 g4, PartitionConfig(), device=dev))}
    gen = torch.Generator(device=dev).manual_seed(8)
    for name, (g, plan) in cases.items():
        s = plan.slabs
        d = route_spmm(g.n_cols, F, int(s["C"]), int(s["R"]))
        if d.backend != "resident":
            raise AssertionError(f"{name}: routed to {d.backend}")
        x = torch.randn((g.n_cols, F), generator=gen, device=dev)
        args = (s["colidx"], s["values"], s["rowloc"], s["out_row"], x,
                plan.n_rows)
        want = spmm_block_slabs_plain(*args)
        bound = pair_bound(torch, spmm_block_slabs_plain, args[:4], x,
                           plan.n_rows,
                           summation_k(g, int(s["C"]), True))
        fns = {"K1 default": lambda: spmm_block_slabs(*args)}
        fns.update(k1_sweep_configs(torch, args))
        for label, fn in fns.items():
            check_close(f"{name} F={F} {label} vs plain", fn(), want, bound)
        a_csr = sparse_csr(torch, [g], [0], plan.n_rows, g.n_cols, dev)
        fns["torch.sparse.mm"] = lambda: torch.sparse.mm(a_csr, x)
        ms = timed_in_turns(fns, 50, device_ms)
        bound_ms = bound_of(g.n_cols, plan.n_rows, F, s, g.nnz)[0]
        log(f"resident regime, {name}: {g.n_rows} nodes, {g.nnz} nnz, "
            f"{plan.num_blocks} blocks, F={F}, X {g.n_cols * F * 4 / 1e6:.1f}"
            f" MB; bound {bound_ms:.4f} ms; ms per call (2 rounds of 50, "
            f"queued behind a busy card):")
        for label, ts in ms.items():
            log(f"resident {name} {label}: {ts[0]:.4f} / {ts[1]:.4f} ms, "
                f"{bound_ms / min(ts) * 100:.2f}% of the bound")
        del want, bound


# ------------------------------------------------------------ slice D
TRAIN_PRESET = "100m"      # examples/train_gcn.py: 9 layers, ~106M params
TRAIN_STEPS = 5
MUTATE_GRAPH = "Arxiv"
MUTATE_F = 2048
MUTATE_DELTAS = 4          # each of MUTATE_EDGES inserts and deletes
MUTATE_EDGES = 250


def grad_bound_rel(C, layers):
    """Relative bound for a gradient of the same parameters through K1
    against the twin. Each aggregation's two fp32 sums differ from the
    exact one by at most (C + 2) u of ``|A| @ |x|`` per row (C products in
    a block, split partials, the add into zero); the forward and backward
    passes run ``2 * layers`` aggregations, each adding at most its own
    relative error, and the pair of paths doubles it. Held per parameter
    against ``max |grad|`` of the twin's."""
    return 2 * 2 * layers * (C + 2) * U


class PlanCount:
    """An aggregation operator that adds K1's launches during each call to
    ``launches``: the launches of one plan (A' or A'^T)."""

    def __init__(self, op):
        self.op, self.launches = op, 0

    def __call__(self, x):
        from repro_torch.kernels.spmm_accel import spmm_block_slabs
        before = spmm_block_slabs.launches
        out = self.op(x)
        self.launches += spmm_block_slabs.launches - before
        return out


def hold_grads(torch, label, got, want, rel):
    """Every gradient within ``rel * max|want|``; returns the largest share
    of the bound used."""
    worst = 0.0
    for i, (pg, pw) in enumerate(zip(got, want)):
        for k in pw:
            scale = float(pw[k].abs().max())
            err = float((pg[k].float() - pw[k].float()).abs().max())
            if err > rel * scale:
                raise AssertionError(f"{label}: layer {i} {k} gradient off "
                                     f"by {err:.3e}, bound {rel * scale:.3e}")
            worst = max(worst, err / (rel * scale) if scale else 0.0)
    return worst


def phase_train(torch, dev, card_line):
    """Slice D's training path: the ``100m`` preset (5,000 nodes, 9 layers,
    ~106M fp32 parameters) through ``examples/train_gcn.py``'s loop on K1,
    forward on A' and backward on A'^T. Returns K1's launches on the path."""
    import tempfile
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.graph import csr_transpose
    from repro_torch.examples import train_gcn as tg
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.models.gcn import GraphOp, gcn_loss

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prob = tg.build_problem(TRAIN_PRESET, "gcn", "accel", dev)
    g = prob.graph
    fwd_plan, bwd_plan = prob.aggr.fwd.plan, prob.aggr.bwd.plan
    C = fwd_plan.config.deg_bound
    layers = len(prob.params)
    n_params = sum(t.numel() for p in prob.params for t in p.values())
    split = {name: int(p.partition.is_split.sum())
             for name, p in (("A'", fwd_plan), ("A'^T", bwd_plan))}
    log(f"train {TRAIN_PRESET}: {g.n_rows} nodes, {g.nnz} nnz after "
        f"gcn_normalize, {layers} layers, {n_params / 1e6:.1f}M parameters; "
        f"A' {fwd_plan.num_blocks} blocks, A'^T {bwd_plan.num_blocks} blocks,"
        f" split blocks {split}; built in {time.perf_counter() - t0:.1f}s")
    if split["A'^T"] == 0:
        raise AssertionError("A'^T has no split rows: the in-degree hubs of "
                             "the directed graph should make some")

    # step 0: K1 against the twin on the card, from the same parameters
    rel = grad_bound_rel(C, layers)
    twin = GraphOp.build(g, backend="blocked", device=dev)
    loss_k, grads_k = tg.loss_and_grads(prob.params, prob.aggr, prob.x,
                                        prob.labels)
    loss_t, grads_t = tg.loss_and_grads(prob.params, twin, prob.x,
                                        prob.labels)
    if abs(float(loss_k) - float(loss_t)) > rel * abs(float(loss_t)):
        raise AssertionError(f"step 0 loss {float(loss_k)} vs twin "
                             f"{float(loss_t)}")
    share = hold_grads(torch, "step 0", grads_k, grads_t, rel)
    log(f"train step 0: loss K1 {float(loss_k):.7f}, twin "
        f"{float(loss_t):.7f}; all {sum(len(p) for p in grads_k)} gradients "
        f"within {rel:.2e} x max|grad| of the twin's (largest share of the "
        f"bound {share:.3e})")
    del twin, grads_k, grads_t

    # one backward aggregation against the CSR oracle of A'^T
    gt = csr_transpose(g)
    up = torch.randn((g.n_rows, 4096), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(11))
    got = prob.aggr.bwd(up)
    want = csr_oracle(torch, gt, up, None)
    mag = csr_oracle(torch, gt, up, None, magnitude=True)
    k = torch.as_tensor(summation_k(gt, C, False), dtype=torch.float64,
                        device=dev)[:, None]
    err = check_close("bwd(g) vs A'^T oracle", got, want, U * k * mag)
    log(f"train: bwd(g) at F=4096 within the summation bound of the fp64 "
        f"CSR oracle of A'^T, max err {err:.2e}")
    del up, got, want, mag, k

    # the main path: SGD steps through the trainer's loop
    fwd, bwd = PlanCount(prob.aggr.fwd), PlanCount(prob.aggr.bwd)
    counted = GraphOp(fwd=fwd, bwd=bwd)
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(TRAIN_STEPS + 1)]
    per_step = []

    def on_step(s, _loss):
        events[s + 1].record()
        per_step.append(spmm_block_slabs.launches)

    spmm_block_slabs.launches = 0          # training path starts here
    spmm_block_slabs.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    events[0].record()
    losses = tg.train(prob.params, counted, prob.x, prob.labels,
                      variant="gcn", lr=1e-2, steps=TRAIN_STEPS,
                      on_step=on_step)
    torch.cuda.synchronize()
    launches = spmm_block_slabs.launches   # training path ends here
    by_instance = dict(spmm_block_slabs.launches_by_instance)
    step_ms = sorted(events[i].elapsed_time(events[i + 1])
                     for i in range(TRAIN_STEPS))
    steps_launches = [b - a for a, b in zip([0] + per_step, per_step)]
    log(f"train: {TRAIN_STEPS} SGD steps, losses "
        + ", ".join(f"{v:.6f}" for v in losses)
        + f"; K1 launches per step {steps_launches} (A' {fwd.launches}, "
        f"A'^T {bwd.launches}); by instance {by_instance}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"losses {losses}: not finite or not falling")
    if steps_launches != [2 * layers] * TRAIN_STEPS or \
            fwd.launches != layers * TRAIN_STEPS or \
            bwd.launches != layers * TRAIN_STEPS:
        raise AssertionError(f"K1 launches per step {steps_launches}, A' "
                             f"{fwd.launches}, A'^T {bwd.launches}: expected "
                             f"{layers} + {layers} per step")

    # where a step's device time goes: K1 against everything else
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tg.loss_and_grads(prob.params, prob.aggr, prob.x, prob.labels)
        torch.cuda.synchronize()
    rows = [(evt.self_device_time_total / 1e3, evt.key)
            for evt in prof.key_averages()
            if evt.device_type == DeviceType.CUDA
            and evt.self_device_time_total > 0]
    busy = sum(r[0] for r in rows)
    k1_ms = sum(ms for ms, key in rows if "slot_order" in key)
    median = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if busy > 0:
        top = sorted(rows, reverse=True)[:4]
        log(f"train step profile: device busy {busy:.2f} ms, K1 {k1_ms:.2f} "
            f"ms ({k1_ms / busy * 100:.1f}% of device time); top: "
            + "; ".join(f"{ms:.2f} ms {key[:50]}" for ms, key in top))
        k1_text = f"K1 {k1_ms:.2f} ms of it by the profiler"
    else:
        k1_ms = None
        k1_text = "K1's share not measured (no device time profiled)"
    log(f"train {TRAIN_PRESET} step: median {median:.2f} ms of "
        f"{', '.join(f'{t:.2f}' for t in step_ms)} ms (CUDA events); "
        f"{k1_text}; peak device memory {peak:.2f} GiB; {card_line}")

    # a checkpoint of the final parameters restores bit for bit
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(TRAIN_STEPS, prob.params)
        back = mgr.restore(mgr.latest_step(), prob.params)
    for p, q in zip(prob.params, back):
        for key in p:
            if not (q[key].device == p[key].device
                    and torch.equal(q[key], p[key])):
                raise AssertionError(f"checkpoint: {key} not restored")
    with torch.no_grad():
        la = float(gcn_loss(prob.params, prob.aggr, prob.x, prob.labels))
        lb = float(gcn_loss(back, prob.aggr, prob.x, prob.labels))
    # split rows of A' add in arrival order (fp32 RED): the same parameters
    # give the same loss up to that order
    tol = 0.0 if split["A'"] == 0 else rel * abs(la)
    if abs(la - lb) > tol:
        raise AssertionError(f"restored loss {lb} vs {la}")
    log(f"train: checkpoint of step {TRAIN_STEPS} restored bit for bit, "
        f"loss {la:.7f} / {lb:.7f}")
    del prob, back, counted, fwd, bwd

    # sage and gin at the tiny preset, K1 against the twin
    for variant in ("sage", "gin"):
        small = tg.build_problem("tiny", variant, "accel", dev)
        twin = GraphOp.build(small.graph, backend="blocked", device=dev)
        nl = len(small.params)
        rel_v = grad_bound_rel(C, nl)
        lk, gk = tg.loss_and_grads(small.params, small.aggr, small.x,
                                   small.labels, variant)
        lt, gtw = tg.loss_and_grads(small.params, twin, small.x,
                                    small.labels, variant)
        if abs(float(lk) - float(lt)) > rel_v * abs(float(lt)):
            raise AssertionError(f"{variant}: loss {float(lk)} vs twin "
                                 f"{float(lt)}")
        s = hold_grads(torch, variant, gk, gtw, rel_v)
        log(f"train tiny {variant}: loss K1 {float(lk):.7f}, twin "
            f"{float(lt):.7f}, gradients within {rel_v:.2e} x max|grad| "
            f"(largest share {s:.3e})")
    return {"launches": launches, "step_ms": median, "k1_ms": k1_ms,
            "peak_gib": peak}


def chain_deltas(g, seed, integer, uniform=False):
    """MUTATE_DELTAS deltas applied in turn from ``g``: each MUTATE_EDGES
    inserts at random and MUTATE_EDGES deletes, one existing edge from each
    of MUTATE_EDGES distinct non-empty rows, or with ``uniform`` drawn
    uniformly over the edges. (Uniform deletes land mostly on the hub rows,
    re-emit their split blocks at every repair and may trip the
    fragmentation guard.) Returns the deltas and the graphs of the chain
    (``g`` first)."""
    import numpy as np
    from repro_torch.core.plan_repair import EdgeDelta
    rng = np.random.default_rng(seed)
    graphs, deltas = [g], []
    for _ in range(MUTATE_DELTAS):
        cur = graphs[-1]
        k = MUTATE_EDGES
        deg = np.diff(cur.rowptr)
        if uniform:
            eids = rng.choice(cur.nnz, k, replace=False)
        else:
            rows = rng.choice(np.flatnonzero(deg > 0), k, replace=False)
            eids = cur.rowptr[rows] + rng.integers(0, deg[rows])
        vals = (rng.integers(1, 4, k) if integer
                else rng.uniform(0.01, 0.2, k))
        d = EdgeDelta(
            insert_src=rng.integers(0, cur.n_rows, k),
            insert_dst=rng.integers(0, cur.n_cols, k),
            insert_val=vals.astype(np.float32),
            delete_src=np.searchsorted(cur.rowptr, eids, side="right") - 1,
            delete_dst=cur.colidx[eids],
            on_duplicate="replace", on_missing="ignore")
        deltas.append(d)
        graphs.append(d.apply(cur))
    return deltas, graphs


def served_ms(torch, engine, name, x, reps=3):
    """Median host time of ``serve_one`` (the engine synchronizes before it
    answers)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.serve_one(name, x)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def phase_mutate(torch, dev, card_line):
    """Slice D's mutation path: the Arxiv analogue in an ``accel`` engine
    (K1) and an ``auto`` engine (K3, the hbm regime at F=2048), 4 deltas
    through ``mutate()`` with reads racing them, then the final version
    against a fresh build; the same on an integer-valued copy, exactly, and
    on that copy again with edge-uniform deletes, where rebuilds are logged
    and not asserted absent. Returns the K1 and K3 launches of the path."""
    import numpy as np
    from repro_torch.core.graph import CSRGraph, gcn_normalize
    from repro_torch.core.plan_cache import build_partition_plan
    from repro_torch.core.plan_repair import delta_chain_hash, repair_plan
    from repro_torch.data.graphs import make_benchmark_graph
    from repro_torch.kernels import ops
    from repro_torch.kernels.spmm_accel import (GATHER_INSTANCES,
                                                spmm_block_slabs)
    from repro_torch.kernels.spmm_hbm import spmm_block_slabs_hbm
    from repro_torch.serve.graph_engine import GraphServeEngine

    raw, _ = make_benchmark_graph(MUTATE_GRAPH, seed=1)
    norm = gcn_normalize(raw)
    ints = CSRGraph(norm.rowptr, norm.colidx, np.random.default_rng(2)
                    .integers(1, 4, norm.nnz).astype(np.float32),
                    norm.n_cols)
    engines = {"accel": GraphServeEngine(device=dev, backend="accel"),
               "auto": GraphServeEngine(device=dev, backend="auto")}
    kernel_of = {"accel": ops.spmm_accel, "auto": ops.spmm_pallas_hbm}
    C = engines["accel"].config.deg_bound
    nnz_chunk = 1 << 17
    gen = torch.Generator(device=dev).manual_seed(21)
    kernels = {"K1": spmm_block_slabs, "K3": spmm_block_slabs_hbm}
    compared = {"K1": 0, "K3": 0}
    for fn in kernels.values():            # mutation path starts here
        fn.launches = 0
        fn.launches_by_instance = dict.fromkeys(GATHER_INSTANCES, 0)
    t_main = time.perf_counter()
    for label, g0, integer, uniform in (
            ("float", norm, False, False), ("integer", ints, True, False),
            ("integer-uniform", ints, True, True)):
        if integer:
            x = torch.randint(-4, 5, (g0.n_cols, MUTATE_F), generator=gen,
                              device=dev).float()
        else:
            x = torch.randn((g0.n_cols, MUTATE_F), generator=gen,
                            device=dev)
        deltas, chain = chain_deltas(g0, seed=31, integer=integer,
                                     uniform=uniform)
        name = f"{MUTATE_GRAPH}-{label}"
        for be, eng in engines.items():
            t0 = time.perf_counter()
            eng.register_graph(name, g0)
            t_reg = time.perf_counter() - t0
            y = eng.serve_one(name, x)
            if integer:
                want = csr_oracle(torch, g0, x, nnz_chunk)
                if not torch.equal(y.double(), want):
                    raise AssertionError(f"{be} {label}: v0 not exact")
            else:
                csr_check(torch, g0, x, y, C, nnz_chunk)
            before = served_ms(torch, eng, name, x)

            # 4 deltas through mutate(), 2 readers submitting meanwhile
            answers, stop = [], threading.Event()

            def reader():
                for _ in range(3):
                    if stop.is_set():
                        return
                    answers.append(eng.submit(name, x).result(timeout=600))

            readers = [threading.Thread(target=reader) for _ in range(2)]
            for th in readers:
                th.start()
            infos, t_mut = [], []
            for d in deltas:                # one published version each
                t0 = time.perf_counter()
                infos.append(eng.mutate(name, d).result(timeout=600))
                t_mut.append(time.perf_counter() - t0)
            stop.set()
            for th in readers:
                th.join(timeout=600)
                if th.is_alive():
                    raise AssertionError("a reader thread did not finish")
            st = eng.stats()
            if eng.graph_version(name) != MUTATE_DELTAS or (
                    not uniform and (not all(i["repaired"] for i in infos)
                                     or st["plan_rebuilds"] != 0)):
                raise AssertionError(f"{be} {label}: {infos}, rebuilds "
                                     f"{st['plan_rebuilds']}")
            seen = set()
            for y in answers:
                seen.add(match_version(torch, chain, x, y, C, nnz_chunk,
                                       integer))
            after = served_ms(torch, eng, name, x)
            final = eng.serve_one(name, x)
            # the final version against a fresh build through the same
            # kernel, and against the oracle
            g_end = chain[-1]
            t0 = time.perf_counter()
            fresh = build_partition_plan(g_end, eng.config, device=dev)
            torch.cuda.synchronize()
            t_fresh = time.perf_counter() - t0
            held = {k: fn.launches for k, fn in kernels.items()}
            fy = kernel_of[be](fresh.slabs, x, fresh.n_rows)[fresh.inv_perm]
            torch.cuda.synchronize()
            for k, fn in kernels.items():    # a comparison, not the path
                compared[k] += fn.launches - held[k]
            if integer:
                want = csr_oracle(torch, g_end, x, nnz_chunk)
                if not (torch.equal(final, fy)
                        and torch.equal(final.double(), want)):
                    raise AssertionError(f"{be} {label}: final version not "
                                         f"exact")
                err = 0.0
            else:
                csr_check(torch, g_end, x, final, C, nnz_chunk)
                k = torch.as_tensor(summation_k(g_end, C, False),
                                    dtype=torch.float64, device=dev)[:, None]
                mag = csr_oracle(torch, g_end, x, nnz_chunk, magnitude=True)
                err = check_close(f"{be} repaired vs fresh", final, fy,
                                  2 * U * k * mag)
                del k, mag
            log(f"mutate {be} {label}: {MUTATE_DELTAS} deltas x "
                f"({MUTATE_EDGES} inserts + {MUTATE_EDGES} deletes) = "
                f"{sum(d.size for d in deltas)} edges of {g0.nnz} nnz; "
                f"versions {[i['version'] for i in infos]}, dirty rows "
                f"{[i['dirty_rows'] for i in infos]}, repaired "
                f"{[i['repaired'] for i in infos]}, repairs "
                f"{st['plan_repairs']}, rebuilds {st['plan_rebuilds']}; "
                f"{len(answers)} racing reads matched versions "
                f"{sorted(seen)}; final vs fresh build max err {err:.2e}; "
                f"register {t_reg:.2f}s, mutate() to published "
                f"{', '.join(f'{t:.3f}' for t in t_mut)}s, fresh build "
                f"{t_fresh:.2f}s; served F={MUTATE_F} {before:.1f} ms "
                f"before, {after:.1f} ms after; {card_line}")
            for v, i in enumerate(infos, 1):
                if not i["repaired"]:
                    log(f"mutate {be} {label}: version {v} rebuilt: "
                        f"{i['reason']}")
            del answers, fresh, fy, final, y
        del x, chain, deltas

    t_main = time.perf_counter() - t_main
    launches = {k: fn.launches - compared[k]              # path ends
                for k, fn in kernels.items()}
    routed = {"K1": engines["accel"].stats()["routed_resident"]
              + engines["auto"].stats()["routed_resident"],
              "K3": engines["auto"].stats()["routed_hbm"]}
    log(f"mutation path: launches {launches}, engines' dispatches {routed}; "
        f"{t_main:.1f}s including the oracle checks")
    if launches != routed or min(launches.values()) < 1:
        raise AssertionError(f"mutation path launches {launches} differ "
                             f"from the dispatches {routed}")
    for eng in engines.values():
        eng.close()

    # one delta's two host steps against a fresh build, on the host clock
    plan = build_partition_plan(norm, engines["accel"].config, device=dev)
    deltas, chain = chain_deltas(norm, seed=31, integer=False)
    d = deltas[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g_new = d.apply(norm)
    t_apply = time.perf_counter() - t0
    t0 = time.perf_counter()
    pv = repair_plan(plan, norm, g_new, d.touched_rows(),
                     graph_hash=delta_chain_hash(plan.graph_hash, d))
    torch.cuda.synchronize()
    t_rep = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_partition_plan(chain[1], engines["accel"].config, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    log(f"mutate: one delta of {d.size} edges: EdgeDelta.apply "
        f"(csr_apply_edge_delta) {t_apply * 1e3:.1f} ms, repair_plan "
        f"{t_rep * 1e3:.1f} ms ({pv.reason}); a fresh build of the "
        f"post-delta plan {t_build * 1e3:.1f} ms; {card_line}")
    return launches


def match_version(torch, chain, x, y, C, nnz_chunk, integer):
    """The index of the version in ``chain`` whose product ``y`` equals
    (exactly on integer graphs, else within the summation bound); raises
    when none does."""
    for v in range(len(chain) - 1, -1, -1):
        g = chain[v]
        want = csr_oracle(torch, g, x, nnz_chunk)
        if integer:
            ok = torch.equal(y.double(), want)
        else:
            mag = csr_oracle(torch, g, x, nnz_chunk, magnitude=True)
            k = torch.as_tensor(summation_k(g, C, False), dtype=torch.float64,
                                device=x.device)[:, None]
            ok = bool(((y.double() - want).abs() <= U * k * mag).all())
        if ok:
            return v
    raise AssertionError("a read racing the mutations matches no version")


# ------------------------------------------------------------ slice C1
# K4 edge cases: rows per expert in blocks (0 = an expert with no rows),
# trailing blocks past the last expert (clipped to E-1, zero rows), m_tile.
# tests/test_torch_kernels_gpu.py holds the same cases: this script imports
# nothing of the tests, so it keeps its own copy.
K4_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0, 16),
    "single_expert": ([4], 0, 16),
    "trailing_blocks": ([1, 2, 0], 3, 8),
    "m_tile_128": ([2, 1, 0, 1], 1, 128),
    "m_tile_160": ([1, 0, 2], 1, 160),
}


def gmm_oracle(torch, x, w, be, m_tile):
    """fp64 ``out[b-th block rows] = x[rows] @ w[be[b]]`` and the same with
    |x| and |w| (the magnitude that scales the summation bound)."""
    M = x.shape[0]
    out = torch.zeros((M, w.shape[2]), dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(out)
    for b, e in enumerate(be.tolist()):
        rows = slice(b * m_tile, (b + 1) * m_tile)
        xb, we = x[rows].double(), w[e].double()
        out[rows] = xb @ we
        mag[rows] = xb.abs() @ we.abs()
    return out, mag


# the wgmma instance's edge cases: rows per expert in blocks, trailing
# clipped blocks; each at m_tile 64, 128, 192 and 256
K4_WGMMA_CASES = {
    "empty_expert": ([2, 0, 1, 3], 0),
    "single_expert": ([3], 0),
    "trailing_blocks": ([1, 2, 0], 3),
}


def k4_case(torch, dev, gen, case, K, N, xd, wd, integer):
    blocks, trailing, m_tile = K4_CASES[case]
    return k4_blocks(torch, dev, gen, blocks, trailing, m_tile, K, N, xd, wd,
                     integer)


def k4_blocks(torch, dev, gen, blocks, trailing, m_tile, K, N, xd, wd,
              integer):
    E = len(blocks)
    be = torch.cat([torch.arange(E, device=dev).repeat_interleave(
        torch.tensor(blocks, device=dev)),
        torch.full((trailing,), E - 1, device=dev)]).to(torch.int32)
    M = be.numel() * m_tile
    if integer:
        x = torch.randint(-2, 3, (M, K), generator=gen, device=dev).float()
        w = torch.randint(-2, 3, (E, K, N), generator=gen, device=dev).float()
    else:
        x = torch.randn((M, K), generator=gen, device=dev)
        w = torch.randn((E, K, N), generator=gen, device=dev)
    x[M - trailing * m_tile:] = 0
    return x.to(xd), w.to(wd), be, m_tile


def k4_on(torch, instance, x, w, be, m_tile, **tiles):
    """K4 through its public wrapper, checking that ``instance`` ran it."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    before = grouped_matmul.launches_by_instance[instance]
    got = grouped_matmul(x, w, be, m_tile=m_tile, **tiles)
    if grouped_matmul.launches_by_instance[instance] != before + 1:
        raise AssertionError(f"K4 on {tuple(x.shape)} {x.dtype} x "
                             f"{tuple(w.shape)} {w.dtype}, m_tile {m_tile}: "
                             f"not launched as {instance}")
    return got


def k4_float_case(torch, label, instance, x, w, be, mt, **tiles):
    """K4 and the plain version each within (K+1) u (|x| @ |w|) of the
    fp64 product; returns (max |K4 - plain|, max error of K4 / bound)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    K = x.shape[1]
    got = k4_on(torch, instance, x, w, be, mt, **tiles)
    plain = grouped_matmul_plain(x, w, be, mt)
    want, mag = gmm_oracle(torch, x, w, be, mt)
    bound = (K + 1) * U * mag
    check_close(f"K4 {label} vs fp64", got, want, bound)
    check_close(f"plain {label} vs fp64", plain, want, bound)
    share = float(((got.double() - want).abs() / bound.clamp_min(1e-300))
                  .max())
    return float((got - plain).abs().max()), share


def phase_k4_cases(torch, dev, arch="dbrx-132b", n_blocks=(144, 20)):
    """K4 against its plain version on edge cases, each asserting the
    instance that ran it. The simt instance: an expert with no rows, a
    single expert, trailing clipped blocks, m_tile 8/16/128/160, K and N
    not multiples of 4, every combination of fp32 and bf16 x and w. The
    wgmma instance (bf16 x and w): the same block structures at m_tile
    64/128/192/256, K 512 and 520 (a ragged last K tile), N 256 and 264 (a
    ragged last column tile), and NaN/Inf in the weights of the experts
    beside the one multiplied. Integer inputs exact; float inputs with K4
    and the plain version each within (K+1) u (|x| @ |w|) of the fp64
    product. Then K4 (wgmma) exact on the wi and wo products at ``arch``'s
    full width, integers |x|, |w| <= 2, bf16, for each of ``n_blocks``
    balanced row blocks (every sum stays below 4 K <= 2**24). Returns max
    |K4 - plain| over the float cases."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import grouped_matmul_plain
    gen = torch.Generator(device=dev).manual_seed(11)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst, n_cases, share = 0.0, 0, 0.0
    for case in K4_CASES:
        for xn, xd in dtypes.items():
            for wn, wd in dtypes.items():
                K, N = 99, 301
                x, w, be, mt = k4_case(torch, dev, gen, case, K, N, xd, wd,
                                       True)
                got = k4_on(torch, "simt", x, w, be, mt, k_tile=K, n_tile=N)
                if not torch.equal(got, grouped_matmul_plain(x, w, be, mt)):
                    raise AssertionError(f"K4 {case} x {xn} w {wn}: differs "
                                         f"from its plain version on integer "
                                         f"inputs")
                K, N = 512, 258
                x, w, be, mt = k4_case(torch, dev, gen, case, K, N, xd, wd,
                                       False)
                err, sh = k4_float_case(torch, f"{case} x {xn} w {wn}",
                                        "simt", x, w, be, mt, n_tile=N)
                worst, share = max(worst, err), max(share, sh)
                n_cases += 2
    log(f"K4 simt == plain on {n_cases // 2} integer cases; {n_cases // 2} "
        f"float cases within (K+1) u (|x| @ |w|) of fp64 (at most "
        f"{share:.4f} of it), max |K4 - plain| {worst:.3e}")
    bf = torch.bfloat16
    n_int = n_float = 0
    share = 0.0
    for case, (blocks, trailing) in K4_WGMMA_CASES.items():
        for mt in (64, 128, 192, 256):
            for K, N in ((512, 256), (520, 264)):
                label = f"wgmma {case} m_tile {mt} K {K} N {N}"
                x, w, be, _ = k4_blocks(torch, dev, gen, blocks, trailing, mt,
                                        K, N, bf, bf, True)
                got = k4_on(torch, "wgmma", x, w, be, mt, k_tile=K, n_tile=N)
                if not torch.equal(got, grouped_matmul_plain(x, w, be, mt)):
                    raise AssertionError(f"K4 {label}: differs from its "
                                         f"plain version on integer inputs")
                x, w, be, _ = k4_blocks(torch, dev, gen, blocks, trailing, mt,
                                        K, N, bf, bf, False)
                err, sh = k4_float_case(torch, label, "wgmma", x, w, be, mt,
                                        k_tile=K, n_tile=N)
                worst, share = max(worst, err), max(share, sh)
                n_int, n_float = n_int + 1, n_float + 1
    for mt in (64, 128):
        for poison in (float("nan"), float("inf")):
            x, w, be, _ = k4_blocks(torch, dev, gen, [0, 3, 0], 0, mt, 520,
                                    264, bf, bf, True)
            w[0] = poison
            w[2] = poison
            got = k4_on(torch, "wgmma", x, w, be, mt, k_tile=520, n_tile=264)
            if not (bool(torch.isfinite(got).all())
                    and torch.equal(got, x.float() @ w[1].float())):
                raise AssertionError(f"K4 wgmma, m_tile {mt}: {poison} in "
                                     f"the weights of experts 0 and 2 "
                                     f"reached expert 1's product")
            n_int += 1
    log(f"K4 wgmma == plain on {n_int} integer cases (4 with NaN/Inf in the "
        f"neighbouring experts' weights); {n_float} float cases within "
        f"(K+1) u (|x| @ |w|) of fp64 (at most {share:.4f} of it); max "
        f"|K4 - plain| over all float cases {worst:.3e}")

    cfg = get_config(arch)
    E, D, FF = cfg.n_experts, cfg.d_model, cfg.d_ff
    for prod, K, N in (("wi", D, FF), ("wo", FF, D)):
        w = torch.randint(-2, 3, (E, K, N), generator=gen,
                          device=dev).to(torch.bfloat16)
        for nb in n_blocks:
            be = (torch.arange(nb, device=dev) * E // nb).to(torch.int32)
            x = torch.randint(-2, 3, (nb * 128, K), generator=gen,
                              device=dev).to(torch.bfloat16)
            got = k4_on(torch, "wgmma", x, w, be, 128)
            want = grouped_matmul_plain(x, w, be)
            if not torch.equal(got, want):
                raise AssertionError(f"K4 at {arch}'s {prod} width "
                                     f"({nb * 128} x {K} @ {E} x {K} x {N},"
                                     f" integers) is not exact")
            log(f"K4 wgmma exact at {arch}'s {prod} width on integers: "
                f"{nb * 128} x {K} @ [{E}, {K}, {N}] bf16, max |out| "
                f"{float(want.abs().max()):.0f}")
            del got, want, x
        del w
    return worst


def dispatched_rows(torch, x, meta):
    """x's (token, slot) rows in moe_block's padded, expert-sorted order:
    the operand of its first two grouped GEMMs."""
    D = x.shape[-1]
    k = meta["ids"].shape[1]
    xs = torch.zeros((meta["M"], D), dtype=x.dtype, device=x.device)
    xs[meta["dst"]] = x.reshape(-1, D)[meta["order"] // k]
    return xs


def k4_pair_check(torch, label, a, w, be, m_tile):
    """K4 against its plain version on the same operands. Each is an fp32
    sum of K products within (K+1) u (|a| @ |w|) of the exact product
    (bf16 x bf16 products are exact in fp32; an fp32 product rounds once),
    so the two differ by at most twice that. |a| @ |w| is itself taken by
    the plain version, an fp32 sum of non-negative terms low by at most a
    factor 1 - (K+1) u, which the bound divides out. Returns (K4's output,
    max |K4 - plain|)."""
    from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                    grouped_matmul_plain)
    K = a.shape[1]
    got = grouped_matmul(a, w, be, m_tile=m_tile)
    plain = grouped_matmul_plain(a, w, be, m_tile)
    mag = grouped_matmul_plain(a.abs(), w.abs(), be, m_tile)
    bound = mag.double() * (2 * (K + 1) * U / (1 - (K + 1) * U))
    del mag
    err = check_close(label, got, plain, bound)
    return got, err


def moe_oracle(torch, p, x, y, ids, route_w, idx):
    """Hold moe_block's output rows ``y[idx]`` against an fp64 oracle
    computed per expert from the same operands (x, the expert weights and
    the router's ids and weights of this run). Returns (max abs error, max
    error / bound).

    The bound, per token and output column, follows the port's dtype flow
    with u the unit roundoff of x's dtype (2**-8 bf16, 2**-24 fp32) and
    v = 2**-24:
      h = x.Wi, g = x.Wg: fp32 sums of D products, then rounded to x's
        dtype:  eh = u|h| + (1+u)(D+1) v (|x|.|Wi|), eg likewise;
      s = silu(g) in fp32 of the rounded g (|silu'| <= 1.1), rounded:
        es = 1.1 eg + (u + 4v)(|s| + 1.1 eg);
      a = s h rounded once:  ea = ep + u(|a| + ep),
        ep = es(|h| + eh) + |s| eh;
      y = a.Wo, an fp32 sum of FF products of the rounded a:
        ey = (ea + (FF+1) v (|a| + ea)) . |Wo|;
      the combine, k fp32 products by the router weights p_j >= 0 summed
      in fp32: eo = sum_j p_j ey_j + (k+1) v sum_j p_j (|y_j| + ey_j);
      the cast of the combine to x's dtype:  eo + u(|out| + eo).
    Every step is the worst case of a rounding or of a sum, so the bound
    holds for any summation order; it is loose by about sqrt(FF) for
    random data, and the ratio it logs shows how loose."""
    v = U
    u = 2.0 ** -8 if x.dtype == torch.bfloat16 else U
    D = x.shape[-1]
    FF = p["wi"].shape[2]
    k = ids.shape[1]
    xt = x.reshape(-1, D)[idx].double()
    ids_s, pw = ids[idx], route_w[idx].double()
    want = torch.zeros((len(idx), D), dtype=torch.float64, device=x.device)
    err = torch.zeros_like(want)
    mag = torch.zeros_like(want)
    for e in torch.unique(ids_s).tolist():
        t_j = (ids_s == e).nonzero()
        rows, slot = t_j[:, 0], t_j[:, 1]
        xe = xt[rows]
        wi, wg, wo = (p[n][e].double() for n in ("wi", "wg", "wo"))
        h, g = xe @ wi, xe @ wg
        eh = u * h.abs() + (1 + u) * (D + 1) * v * (xe.abs() @ wi.abs())
        eg = u * g.abs() + (1 + u) * (D + 1) * v * (xe.abs() @ wg.abs())
        del wi, wg
        s = torch.nn.functional.silu(g)
        es = 1.1 * eg + (u + 4 * v) * (s.abs() + 1.1 * eg)
        a = s * h
        ep = es * (h.abs() + eh) + s.abs() * eh
        ea = ep + u * (a.abs() + ep)
        ye = a @ wo
        ey = (ea + (FF + 1) * v * (a.abs() + ea)) @ wo.abs()
        pj = pw[rows, slot][:, None]
        want.index_add_(0, rows, pj * ye)
        err.index_add_(0, rows, pj * ey)
        mag.index_add_(0, rows, pj * (ye.abs() + ey))
    eo = err + (k + 1) * v * mag
    bound = eo + u * (want.abs() + eo)
    got = y.reshape(-1, D)[idx]
    max_err = check_close("moe_block vs fp64 oracle", got, want, bound)
    ratio = float(((got.double() - want).abs() / bound).max())
    return max_err, ratio


def phase_moe(torch, dev, arch="dbrx-132b", tokens=((4, 1024), (128, 1)),
              skew=8.0, sample=256):
    """Slice C1's main path: ``moe_block`` at ``arch``'s full width through
    K4. Weights from ``init_moe`` with a seeded generator on the card
    (router fp32, experts bf16); x bf16 [B, T, D] from a seed for each
    token shape, with balanced and skewed routing (+``skew`` on the router
    column of expert 0, as examples/moe_block_dispatch.py does); then one
    fp32 run (fp32 weights and x) at the first token shape, balanced. The
    K4 launches of these five calls are the path's count: 3 per call. Then
    in each case the dispatch is rebuilt from the router (``block_dispatch``
    with moe_block's default m_tile) and each of the three products (wi,
    wg, then wo on the gated h) is held against the plain version on the
    same operands (``k4_pair_check``); the outputs of K4's path and of the
    twin (use_pallas=False) are held against an fp64 oracle over a seeded
    sample of ``sample`` tokens. Returns what the timing phase needs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.models.moe import (_route, block_dispatch, init_moe,
                                        moe_block)
    m_tile = 128                           # moe_block's default
    cfg = get_config(arch)
    D, FF, E, k = cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.top_k
    kw = dict(top_k=k, n_experts=E)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    p = init_moe(gen, D, FF, E, device=dev)
    p32 = init_moe(gen, D, FF, E, dtype=torch.float32, device=dev)
    bias = torch.zeros(E, device=dev)
    bias[0] = skew
    routers = {"balanced": p, "skewed": dict(p, router=p["router"] + bias)}
    xgen = torch.Generator(device=dev).manual_seed(1)
    xs = {bt: torch.randn((*bt, D), generator=xgen, device=dev).to(
        torch.bfloat16) for bt in tokens}
    x32 = torch.randn((*tokens[0], D), generator=xgen, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"{arch}: d_model={D} d_ff={FF} {E} experts top-{k}; expert weights "
        f"{sum(p[n].numel() for n in ('wi', 'wg', 'wo')) * 2 / 1e9:.2f} GB "
        f"bf16 and {sum(p32[n].numel() for n in ('wi', 'wg', 'wo')) * 4 / 1e9:.2f}"
        f" GB fp32, drawn in {time.perf_counter() - t0:.1f}s")

    runs = [(f"{bt[0] * bt[1]} tokens {name}", routers[name], xs[bt])
            for bt in tokens for name in ("balanced", "skewed")]
    runs.append((f"{tokens[0][0] * tokens[0][1]} tokens balanced fp32", p32,
                 x32))
    grouped_matmul.launches = 0            # main path starts here
    grouped_matmul.launches_by_instance = {"wgmma": 0, "simt": 0}
    t_main = time.perf_counter()
    outs = []
    for label, params, x in runs:
        before = grouped_matmul.launches
        y, aux = moe_block(params, x, **kw)
        outs.append((y, aux, grouped_matmul.launches - before))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_main = time.perf_counter() - t_main
    launches = grouped_matmul.launches     # main path ends here
    by_instance = dict(grouped_matmul.launches_by_instance)
    per_call = [n for _, _, n in outs]
    log(f"moe_block main path: {len(runs)} calls in {t_main:.2f}s, K4 "
        f"launches {launches} ({per_call} per call; by instance "
        f"{by_instance})")
    if launches != 3 * len(runs) or any(n != 3 for n in per_call):
        raise AssertionError(f"K4 launches {per_call} per moe_block call, "
                             f"want 3 each")
    # every bf16 call runs on the tensor cores, the fp32 one on the CUDA
    # cores
    want = {"wgmma": 3 * (len(runs) - 1), "simt": 3}
    if by_instance != want:
        raise AssertionError(f"K4 launches by instance {by_instance}, want "
                             f"{want}")

    sgen = torch.Generator().manual_seed(2)
    metas = []
    for (label, params, x), (y, aux, _) in zip(runs, outs):
        n_tok = x.shape[0] * x.shape[1]
        if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype or \
                not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{label}: output {tuple(y.shape)} "
                                 f"{y.dtype} not finite or of x's shape")
        route_w, ids, _ = _route(params, x.reshape(-1, D), k, True)
        meta = block_dispatch(ids, E, m_tile)
        metas.append(meta)
        be = meta["block_expert"]
        xs_r = dispatched_rows(torch, x, meta)
        h, err_i = k4_pair_check(torch, f"{label}: K4 wi vs plain", xs_r,
                                 params["wi"], be, m_tile)
        g, err_g = k4_pair_check(torch, f"{label}: K4 wg vs plain", xs_r,
                                 params["wg"], be, m_tile)
        del xs_r
        h, g = h.to(x.dtype), g.to(x.dtype)
        h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
        del g
        _, err_o = k4_pair_check(torch, f"{label}: K4 wo vs plain", h,
                                 params["wo"], be, m_tile)
        del h
        y_t, _ = moe_block(params, x, use_pallas=False, **kw)
        idx = torch.randperm(n_tok, generator=sgen)[:sample].to(dev)
        err, ratio = moe_oracle(torch, params, x, y, ids, route_w, idx)
        err_t, ratio_t = moe_oracle(torch, params, x, y_t, ids, route_w, idx)
        counts = meta["counts"].double()
        live = int((-(-meta["counts"] // m_tile)).sum())
        log(f"{label}: loads max/mean {float(counts.max() / counts.mean()):.2f}"
            f" (min {int(counts.min())}, max {int(counts.max())}), "
            f"{be.numel()} blocks ({live} live), aux {float(aux):.4f}; max "
            f"|K4 - plain| wi {err_i:.3e} wg {err_g:.3e} wo {err_o:.3e}; vs "
            f"fp64 oracle on {len(idx)} tokens: K4 max err {err:.3e} "
            f"({ratio:.4f} of the bound), twin {err_t:.3e} ({ratio_t:.4f}); "
            f"max |K4 path - twin| "
            f"{float((y.float() - y_t.float()).abs().max()):.3e}")
        del y_t
    # the balanced runs' dispatch at each token shape, for the timing phase
    return p, p32, xs, x32, metas[0:2 * len(tokens):2], launches


def gmm_bound(M, K, N, n_used, x_bytes, w_bytes, peak, nb):
    """The least time the card could take for one grouped GEMM: its flops
    (padding rows included: K4 multiplies them) over ``peak``, or its
    bytes (x, the weights of the experts used, the fp32 output and the
    block ids, each once) over the memory rate."""
    flops = 2.0 * M * K * N
    moved = M * K * x_bytes + n_used * K * N * w_bytes + M * N * 4 + nb * 4
    ops_ms, bytes_ms = flops / peak * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", flops, moved)


def k4_c_launch(torch, lib, instance, a, w, be, m_tile):
    """K4 through its C interface with the instance (0 simt, 1 wgmma)
    chosen here; the wrapper picks it from the operands. Not counted as a
    launch of the main path."""
    M, K = a.shape
    E, _, N = w.shape
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = lib.grouped_matmul_launch(
        a.data_ptr(), w.data_ptr(), be.data_ptr(), out.data_ptr(),
        int(a.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16), E,
        M // m_tile, m_tile, K, N, instance,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"K4 launch (instance {instance}) failed: "
                           f"{lib.grouped_matmul_error_string(err).decode()}")
    return out


def phase_timing_k4(torch, p, p32, xs_by_shape, x32, metas, launches,
                    float_err, reps=10, reps_f32=3):
    """K4 at the token shapes of phase_moe (balanced). At the first (the
    prefill chunk): each of the three GEMMs in bf16 (wgmma), the wi product
    through the simt instance on the same bf16 operands and with fp32
    operands, the plain version of wi, and torch._grouped_mm (bf16 in and
    out; a yardstick the port never calls). Every timed wi output is held
    against the plain version within the pair bound of k4_pair_check. At
    the second (a decode step): the three GEMMs beside their bound. Then
    the whole moe_block at every token shape. K4 is timed through the
    entry moe_block uses, which skips the public wrapper's expert-id range
    check and its device sync."""
    from repro_torch.kernels.grouped_matmul import (
        grouped_matmul_in_range as grouped_matmul, grouped_matmul_plain,
        load_grouped_matmul)
    from repro_torch.models.moe import moe_block
    lib = load_grouped_matmul()
    shapes = list(xs_by_shape)
    x = xs_by_shape[shapes[0]]
    meta = metas[0]
    D = x.shape[-1]
    E, _, FF = p["wi"].shape
    k = meta["ids"].shape[1]
    be, M = meta["block_expert"], meta["M"]
    m_tile = M // be.numel()
    xs = dispatched_rows(torch, x, meta)
    xs32 = dispatched_rows(torch, x32, meta)
    plain = grouped_matmul_plain(xs, p["wi"], be, m_tile)
    pair = grouped_matmul_plain(xs.abs(), p["wi"].abs(), be, m_tile).double()
    pair *= 2 * (D + 1) * U / (1 - (D + 1) * U)
    held = {}

    def hold(label, got):
        check_close(f"K4 {label} vs plain", got, plain, pair)
        held[label] = float(((got.double() - plain).abs()
                             / pair.clamp_min(1e-300)).max())

    h = grouped_matmul(xs, p["wi"], be).to(x.dtype)
    g = grouped_matmul(xs, p["wg"], be).to(x.dtype)
    h = torch.nn.functional.silu(g.float()).to(x.dtype) * h
    del g
    n_used = int((meta["counts"] > 0).sum())
    gemms = {"wi": (xs, p["wi"]), "wg": (xs, p["wg"]), "wo": (h, p["wo"])}
    ms = {}
    for name, (a, w) in gemms.items():
        grouped_matmul(a, w, be)
        ms[name] = cuda_ms(lambda a=a, w=w: grouped_matmul(a, w, be), reps)
    hold("wi wgmma", grouped_matmul(xs, p["wi"], be))
    simt = lambda: k4_c_launch(torch, lib, 0, xs, p["wi"], be,  # noqa: E731
                               m_tile)
    hold("wi simt", simt())
    ms["wi simt"] = cuda_ms(simt, reps_f32)
    grouped_matmul(xs32, p32["wi"], be)
    ms["wi fp32"] = cuda_ms(lambda: grouped_matmul(xs32, p32["wi"], be),
                            reps_f32)
    ms["wi again"] = cuda_ms(lambda: grouped_matmul(xs, p["wi"], be), reps)
    ms["plain"] = cuda_ms(
        lambda: grouped_matmul_plain(xs, p["wi"], be, m_tile), 3)
    del plain, pair
    offs = torch.cumsum(-(-meta["counts"] // m_tile) * m_tile, 0).to(
        torch.int32)
    if hasattr(torch, "_grouped_mm"):
        lib_mm = lambda: torch._grouped_mm(  # noqa: E731
            xs, p["wi"], offs=offs)
        got, ref = lib_mm(), grouped_matmul(xs, p["wi"], be)
        rows = int(offs[-1])
        lib_err = float((got[:rows].float() - ref[:rows]).abs().max()
                        / ref[:rows].abs().max())
        del got, ref
        library_ms = cuda_ms(lib_mm, reps)
        log(f"torch._grouped_mm (bf16 output, the {rows} rows the experts "
            f"cover; the {M - rows} trailing rows skipped): {library_ms:.3f}"
            f" ms, max |lib - K4| / max|K4| {lib_err:.2e}")
    else:
        library_ms = None
        log(f"torch {torch.__version__} has no torch._grouped_mm: "
            f"library_ms is null")
    bounds = {}
    for name, (a, w) in gemms.items():
        K, N = w.shape[1], w.shape[2]
        bounds[name] = gmm_bound(M, K, N, n_used, 2, 2, BF16_FLOPS,
                                 be.numel())
    bounds["wi simt"] = bounds["wi"]
    bounds["wi fp32"] = gmm_bound(M, D, FF, n_used, 4, 4, FP32_FLOPS,
                                  be.numel())
    for name, (b_ms, b_by, flops, moved) in bounds.items():
        log(f"K4 {name} at {M} rows: {ms[name]:.3f} ms, "
            f"{flops / ms[name] / 1e9:.2f} TFLOP/s; bound {b_ms:.3f} ms by "
            f"{b_by} ({flops / 1e12:.3f} TFLOP, {moved / 1e9:.3f} GB); "
            f"{b_ms / ms[name] * 100:.2f}% of the bound")
    log("K4 wi, max |K4 - plain| as a share of the pair bound: " + ", ".join(
        f"{label} {share:.3e}" for label, share in held.items()))
    log(f"K4 wi again {ms['wi again']:.3f} ms; wgmma "
        f"{ms['wi simt'] / ms['wi']:.1f}x faster than simt on the same bf16 "
        f"operands; plain version of wi (fp32 cuBLAS per expert run) "
        f"{ms['plain']:.3f} ms")
    del xs, xs32, h

    for bt, meta_d in zip(shapes[1:], metas[1:]):
        xd = xs_by_shape[bt]
        be_d, M_d = meta_d["block_expert"], meta_d["M"]
        a_d = dispatched_rows(torch, xd, meta_d)
        h_d = grouped_matmul(a_d, p["wi"], be_d).to(xd.dtype)
        g_d = grouped_matmul(a_d, p["wg"], be_d).to(xd.dtype)
        h_d = torch.nn.functional.silu(g_d.float()).to(xd.dtype) * h_d
        del g_d
        used = int((meta_d["counts"] > 0).sum())
        live = int((-(-meta_d["counts"] // m_tile)).sum())
        for name, a in (("wi", a_d), ("wg", a_d), ("wo", h_d)):
            w = p[name]
            grouped_matmul(a, w, be_d)
            t = cuda_ms(lambda a=a, w=w: grouped_matmul(a, w, be_d), reps)
            b_ms, b_by, fl, moved = gmm_bound(M_d, w.shape[1], w.shape[2],
                                              used, 2, 2, BF16_FLOPS,
                                              be_d.numel())
            log(f"K4 {name} at {bt[0] * bt[1]} tokens ({M_d} rows, "
                f"{be_d.numel()} blocks, {live} live, {used} experts): "
                f"{t:.3f} ms, {fl / t / 1e9:.2f} TFLOP/s, "
                f"{moved / t / 1e9:.3f} TB/s; bound {b_ms:.3f} ms by {b_by} "
                f"({moved / 1e9:.3f} GB); {b_ms / t * 100:.2f}% of the bound")
        del a_d, h_d
    for bt in shapes:
        xb = xs_by_shape[bt]
        moe_block(p, xb, top_k=k, n_experts=E)
        t = cuda_ms(lambda xb=xb: moe_block(p, xb, top_k=k, n_experts=E),
                    reps)
        log(f"whole moe_block at {bt[0] * bt[1]} tokens (balanced): "
            f"{t:.3f} ms; reading the {E} experts' bf16 weights once takes "
            f"{3 * p['wi'].numel() * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
            f"the memory rate")
    return {"name": "grouped_matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/grouped_matmul.cu",
            "replaces": "src/repro/kernels/grouped_matmul.py:33",
            "launches": launches, "max_abs_err": float_err,
            "ms": ms["wi"], "plain_ms": ms["plain"],
            "bound_ms": bounds["wi"][0], "bound_by": bounds["wi"][1],
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
    graphs, engine, launches_a = phase_serve(torch, dev)
    phase_profile(torch, engine, graphs)
    engine.close()
    small, small_engine, launches = phase_routed(torch, dev, graphs,
                                                 engine.cache)
    small_engine.close()
    # K1's record keeps slice A's path count; K2 and K3 report slice B1's
    launches["K1"] = launches_a
    k1, k3 = phase_timing(torch, graphs, engine, launches, float_err)
    phase_timing_resident(torch, small, small_engine)
    k2 = phase_timing_k2(torch, small, small_engine, launches,
                         float_err["K2"])
    del graphs, engine, small, small_engine
    gc.collect()
    torch.cuda.empty_cache()                # the GCN phases' memory goes
    peak = torch.cuda.max_memory_allocated()  # phase 8 resets the peak
    train = phase_train(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    mutate = phase_mutate(torch, dev, card_line)
    gc.collect()
    torch.cuda.empty_cache()
    k1["launches_by_path"] = {"serve": launches_a,
                              "train": train["launches"],
                              "mutate": mutate["K1"]}
    k3["launches_by_path"] = {"routed": launches["K3"],
                              "mutate": mutate["K3"]}
    k4_err = phase_k4_cases(torch, dev)
    p, p32, xs, x32, metas, k4_launches = phase_moe(torch, dev)
    k4 = phase_timing_k4(torch, p, p32, xs, x32, metas, k4_launches, k4_err)
    peak = max(peak, torch.cuda.max_memory_allocated())
    log(f"peak device memory {peak / 2**30:.2f} GiB; total "
        f"{time.perf_counter() - t0:.1f}s")
    records = [k1, k2, k3, k4]
    print(json.dumps({"kernels": records}))
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
