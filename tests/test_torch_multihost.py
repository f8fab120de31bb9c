"""The port's multi-host layer (``distributed/multihost.py``,
``launch/mesh.py::multihost_graph_mesh``, the global half of
``distributed/shard_spmm.py`` and ``serve/fleet.py::MultihostGraphEngine``)
on the CPU, against the reference.

* **The wire.** The port's ``PeerClient`` against the reference's
  ``PeerServer`` and the reverse, in this process: the handshake, a request
  with numpy payloads, a remote error, ``ConnectionError`` once the
  channel breaks and then a reconnect, ``ConnectionError`` from a peer that
  is gone; both packages write the same frame bytes.
* **Two processes x 4 CPU slots** under ``run_fleet`` (gloo), the port of
  ``tests/test_multihost.py``: both ranks serve every graph concurrently,
  each forwarding what the other owns, every answer within 1e-4 of the
  reference's single-host ``blocked`` engine (computed here, in the
  parent, on the same graphs); then ``serve_global`` over the 8 global
  slots on a 6,000-node graph within 1e-4 of the reference, and on an
  integer copy bit-equal to the port's single-process
  ``spmm_block_sharded`` over 8 CPU slots.
* **Mutation**, in this process over real peer TCP: the reference's two
  cases (``tests/test_mutation_serve.py``), on the port's engines.
* **The frontier exchange**, the port of
  ``test_cross_partition_exchange_two_processes``: two processes each own
  half the store and sample frontiers straddling the boundary through
  ``FrontierExchange``; every frontier's ``content_key`` equals the
  reference's monolithic sampler's, with zero failovers.

Every spawned fleet has a 120 s limit and a 60 s gloo timeout.
"""
import json
import os
import socket
import textwrap

import numpy as np
import pytest
import torch

from repro.distributed import multihost as ref_mh
from repro_torch.core.graph import CSRGraph
from repro_torch.core.plan_repair import EdgeDelta
from repro_torch.distributed import multihost as port_mh
from repro_torch.distributed.multihost import (
    MultihostContext, PeerClient, initialize_multihost, run_cpu_fleet,
    run_fleet,
)
from repro_torch.launch.mesh import graph_mesh, multihost_graph_mesh
from repro_torch.serve import MultihostGraphEngine

from conftest import make_powerlaw_csr

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLEET_TIMEOUT_S = 120.0
_PACKAGES = {"repro": ref_mh, "repro_torch": port_mh}


# ------------------------------------------------------------------- wire
@pytest.mark.parametrize("server_pkg,client_pkg",
                         [("repro", "repro_torch"), ("repro_torch", "repro")])
def test_peer_frames_interoperate(server_pkg, client_pkg):
    S, C = _PACKAGES[server_pkg], _PACKAGES[client_pkg]
    server = S.PeerServer(0, process_index=1, epoch=3, n_devices=2)
    port = server.port

    def boom(_payload):
        raise ValueError("boom")

    def echo(p):
        return {"sum": p["a"] + p["b"], "tag": p["tag"]}

    server.register("echo", echo)
    server.register("boom", boom)
    client = C.PeerClient(("127.0.0.1", port), process_index=0, epoch=0,
                          timeout_s=10, connect_timeout_s=5)
    try:
        assert client.handshake() == (1, 3)
        assert client.peer_devices == 2
        a = np.arange(12, dtype=np.float32).reshape(3, 4)
        out = client.request("echo", {"a": a, "b": np.float32(2) * a,
                                      "tag": ("x", 7)})
        np.testing.assert_array_equal(out["sum"], 3 * a)
        assert out["sum"].dtype == np.float32 and out["tag"] == ("x", 7)
        with pytest.raises(RuntimeError, match="boom"):
            client.request("boom", None)
        with pytest.raises(RuntimeError, match="unknown op"):
            client.request("nope", None)
        # the channel breaks under the client: ConnectionError, then the
        # next request reconnects with a fresh handshake
        client._sock.shutdown(socket.SHUT_RDWR)
        with pytest.raises(ConnectionError):
            client.request("echo", {"a": a, "b": a, "tag": None})
        assert client._sock is None            # the channel was reset
        out = client.request("echo", {"a": a, "b": a, "tag": None})
        np.testing.assert_array_equal(out["sum"], 2 * a)
        assert client.peer_epoch == 3
        # a peer that is gone for good: ConnectionError once the connect
        # window closes
        dead = C.PeerClient(("127.0.0.1", port_mh.free_port()),
                            connect_timeout_s=0.3)
        with pytest.raises(ConnectionError):
            dead.request("echo", None)
    finally:
        client.close()
        server.close()


def test_frame_bytes_identical_across_packages():
    obj = ("serve", {"graph_id": "g", "x": np.ones((3, 2), np.float32)})
    frames = []
    for mod in (ref_mh, port_mh):
        a, b = socket.socketpair()
        with a, b:
            mod._send_frame(a, obj)
            a.shutdown(socket.SHUT_WR)
            frames.append(b"".join(iter(lambda: b.recv(1 << 16), b"")))
    assert frames[0] == frames[1]
    for mod in (ref_mh, port_mh):
        a, b = socket.socketpair()
        with a, b:
            a.sendall(frames[0])
            got = mod._recv_frame(b)
        assert got[0] == "serve"
        np.testing.assert_array_equal(got[1]["x"], obj[1]["x"])


# ------------------------------------------------------------------- mesh
def test_multihost_graph_mesh_degenerates_on_one_process(monkeypatch):
    for var in ("REPRO_MH_COORD", "REPRO_MH_NPROCS", "REPRO_MH_PID",
                "REPRO_MH_SLOTS", "REPRO_MH_DEVICE", "REPRO_MH_EPOCH"):
        monkeypatch.delenv(var, raising=False)
    ctx = initialize_multihost(device="cpu", n_local_slots=3)
    cpu = torch.device("cpu")
    assert (ctx.process_index, ctx.process_count) == (0, 1)
    assert ctx.local_devices == [cpu] * 3
    assert ctx.global_devices == [(0, 0), (0, 1), (0, 2)]
    assert multihost_graph_mesh(ctx) == [cpu] * 3
    assert multihost_graph_mesh(device="cpu") == graph_mesh(device="cpu")
    assert initialize_multihost(device="cpu").local_devices == \
        graph_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            initialize_multihost()               # cuda unless told cpu
        with pytest.raises(RuntimeError, match="CUDA"):
            MultihostGraphEngine()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(num_processes=2, device="cpu")


def test_single_process_engine_serves_locally():
    ctx = initialize_multihost(num_processes=1, device="cpu",
                               n_local_slots=2)
    g = _port(make_powerlaw_csr(n=80, seed=4))
    engine = MultihostGraphEngine(context=ctx, backend="blocked",
                                  serve_port=0)
    try:
        assert engine.register_graph("g", g) is not None   # sole owner
        x = torch.ones((g.n_cols, 3))
        np.testing.assert_allclose(engine.serve_global("g", x).numpy(),
                                   _dense(g) @ np.ones((g.n_cols, 3)),
                                   rtol=1e-5, atol=1e-5)
        st = engine.stats()
        assert st["fleet_hosts"] == 1 and st["fleet_forwarded"] == 0
        assert st["fleet_global_dispatches"] == 0      # no collective
    finally:
        engine.close()


# ------------------------------------------------------------ two processes
_FLEET_WORKER = textwrap.dedent("""
    import json, os, sys, threading
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.multihost import initialize_multihost
    ctx = initialize_multihost(timeout_s=60)       # env-driven (REPRO_MH_*)
    from repro_torch.core.graph import CSRGraph
    from repro_torch.distributed.shard_spmm import spmm_block_sharded
    from repro_torch.serve import GraphRequest, MultihostGraphEngine

    data = np.load(os.environ["MH_DATA"])
    def graph(name):
        return CSRGraph(data[name + "/rowptr"], data[name + "/colidx"],
                        data[name + "/values"], int(data[name + "/n_cols"]))

    assert ctx.process_count == 2 and len(ctx.global_devices) == 8
    engine = MultihostGraphEngine(context=ctx, backend="accel",
                                  max_graphs_per_batch=4)
    served_evt = threading.Event()
    engine.server.register("phase-served", lambda _p: served_evt.set())
    engine.connect_peers()

    names = [n for n in json.loads(os.environ["MH_GRAPHS"])]
    owned = 0
    for gid in names + ["big", "big#int"]:
        owned += int(engine.register_graph(gid, graph(gid)) is not None)
    dist.barrier()          # no rank forwards before its peer registered
    reqs = [GraphRequest(g, torch.from_numpy(data[g + "/x"])) for g in names]
    mh = engine.serve(reqs)
    max_err = max(float(np.max(np.abs(r.out.numpy() - data[r.graph_id
                                                           + "/want"])))
                  for r in mh)
    peer = engine.peers[1 - ctx.process_index]
    peer.request("phase-served", None)
    assert served_evt.wait(60), "peer never finished serving"

    out = engine.serve_global("big", torch.from_numpy(data["big/x"]))
    g_err = float(np.max(np.abs(out.numpy() - data["big/want"])))
    blocks = engine.stats()["fleet_block_counts"]
    xi = torch.from_numpy(data["big#int/x"])
    out_i = engine.serve_global("big#int", xi)
    plan = engine.plan_for("big#int")
    want_i, _ = spmm_block_sharded(plan.slabs, xi, plan.n_rows,
                                   [torch.device("cpu")] * 8)
    st = engine.stats()
    engine.close()
    dist.destroy_process_group()
    print(json.dumps({
        "rank": ctx.process_index,
        "hosts": st["fleet_hosts"],
        "owned_plans": owned,
        "forwarded": st["fleet_forwarded"],
        "remote_served": st["fleet_remote_served"],
        "host_placements": st["fleet_dir_host_placements"],
        "global_dispatches": st["fleet_global_dispatches"],
        "block_counts": blocks,
        "max_err": max_err,
        "global_err": g_err,
        "global_int_equal": bool(torch.equal(out_i,
                                             want_i[plan.inv_perm])),
        "global_int_exact": bool(np.array_equal(out_i.numpy(),
                                                data["big#int/want"])),
        "failovers": st["fleet_host_failovers"],
        "sched_invariant": (st["sched_completed"] + st["sched_failed"]
                            + st["sched_cancelled"]
                            == st["sched_submitted"]),
    }))
""")


def _port(g):
    return CSRGraph(g.rowptr, g.colidx, g.values.astype(np.float32),
                    g.n_cols)


def _dense(g):
    a = np.zeros((g.n_rows, g.n_cols), np.float64)
    row = np.repeat(np.arange(g.n_rows), np.diff(g.rowptr))
    np.add.at(a, (row, g.colidx.astype(np.int64)),
              g.values.astype(np.float64))
    return a


def _fleet_data(path):
    """The graphs, features and the reference's answers, written once by
    the parent so both ranks register identical content."""
    import jax.numpy as jnp
    from repro.core.graph import csr_from_edges, gcn_normalize
    from repro.data.graphs import make_power_law_graph
    from repro.serve.graph_engine import GraphRequest as RefRequest
    from repro.serve.graph_engine import GraphServeEngine as RefEngine
    rng = np.random.default_rng(0)
    graphs = {f"g{i}": gcn_normalize(make_power_law_graph(
        140 + 35 * i, 900 + 70 * i, seed=i)) for i in range(6)}
    graphs["big"] = gcn_normalize(make_power_law_graph(6000, 30000, seed=9))
    b = graphs["big"]
    graphs["big#int"] = csr_from_edges(
        np.repeat(np.arange(b.n_rows), np.diff(b.rowptr)), b.colidx,
        b.n_cols, values=rng.integers(1, 4, b.nnz).astype(np.float32))
    arrays, feats = {}, {}
    for gid, g in graphs.items():
        for k in ("rowptr", "colidx", "values"):
            arrays[f"{gid}/{k}"] = np.asarray(getattr(g, k))
        arrays[f"{gid}/n_cols"] = np.int64(g.n_cols)
        F = 16 if gid.startswith("big") else 8 + 4 * int(gid[1:])
        feats[gid] = (rng.integers(-4, 5, (g.n_cols, F)).astype(np.float32)
                      if gid == "big#int" else
                      rng.normal(size=(g.n_cols, F)).astype(np.float32))
        arrays[f"{gid}/x"] = feats[gid]
    single = RefEngine(backend="blocked", max_graphs_per_batch=4)
    try:
        for gid, g in graphs.items():
            single.register_graph(gid, g)
        out = single.serve([RefRequest(gid, jnp.asarray(x))
                            for gid, x in feats.items()])
    finally:
        single.close()
    for r in out:
        arrays[f"{r.graph_id}/want"] = np.asarray(r.out)
    np.savez(path, **arrays)
    return [gid for gid in graphs if gid.startswith("g")]


def test_two_process_fleet_forwards_and_serves_global(tmp_path):
    path = str(tmp_path / "fleet.npz")
    names = _fleet_data(path)
    records = run_fleet(_FLEET_WORKER, num_processes=2, n_local_slots=4,
                        device="cpu", timeout_s=FLEET_TIMEOUT_S,
                        cwd=REPO_ROOT,
                        extra_env={"MH_DATA": path,
                                   "MH_GRAPHS": json.dumps(names)})
    assert len(records) == 2
    r0, r1 = sorted(records, key=lambda r: r["rank"])
    for r in (r0, r1):
        assert r["hosts"] == 2
        assert r["owned_plans"] >= 1
        assert r["failovers"] == 0
        assert r["sched_invariant"]
        assert len(r["host_placements"]) == 2
        assert all(c >= 1 for c in r["host_placements"])
        # the mutual pattern: each rank forwarded AND answered forwards
        assert r["forwarded"] >= 1 and r["remote_served"] >= 1
        assert r["max_err"] < 1e-4
        # the collective dispatches ran on both ranks over all 8 slots
        assert r["global_dispatches"] == 2
        assert len(r["block_counts"]) == 8
        assert max(r["block_counts"]) - min(r["block_counts"]) <= 1
        assert r["global_err"] < 1e-4
        assert r["global_int_equal"] and r["global_int_exact"]


# ----------------------------------------------------------------- mutation
def _delta(g, seed, k=3):
    """A small mixed delta valid against ``g`` (the reference test's)."""
    rng = np.random.default_rng(seed)
    eids = rng.choice(g.nnz, k, replace=False)
    rows = rng.integers(0, g.n_rows, k)
    return EdgeDelta(
        insert_src=rows, insert_dst=rng.integers(0, g.n_cols, k),
        insert_val=rng.normal(size=k).astype(np.float32),
        delete_src=np.searchsorted(g.rowptr, eids, side="right") - 1,
        delete_dst=g.colidx[eids],
        on_duplicate="replace", on_missing="ignore")


def _two_host_engines():
    devs = [torch.device("cpu")]

    def ctx(i):
        return MultihostContext(process_index=i, process_count=2,
                                coordinator=None, local_devices=devs,
                                global_devices=[(0, 0), (1, 0)])

    a = MultihostGraphEngine(context=ctx(0), serve_port=0,
                             peer_addresses={}, backend="blocked")
    b = MultihostGraphEngine(context=ctx(1), serve_port=0,
                             peer_addresses={}, backend="blocked")
    a.peers = {1: PeerClient(("127.0.0.1", b.server.port),
                             process_index=0, epoch=0)}
    b.peers = {0: PeerClient(("127.0.0.1", a.server.port),
                             process_index=1, epoch=0)}
    a.connect_peers()
    b.connect_peers()
    return a, b


def test_multihost_mutation_converges_both_hosts():
    from repro.core.graph import gcn_normalize
    a, b = _two_host_engines()
    try:
        rng = np.random.default_rng(0)
        pool = {}
        for i in range(6):
            gid = f"g{i}"
            g = _port(gcn_normalize(make_powerlaw_csr(n=50 + 10 * i, seed=i)))
            pool[gid] = g
            a.register_graph(gid, g)
            b.register_graph(gid, g)
        all_owners = {gid: a.directory.place(a._keys[gid]).host
                      for gid in pool}
        assert set(all_owners.values()) == {0, 1}, all_owners
        picks = {h: next(g for g, o in all_owners.items() if o == h)
                 for h in (0, 1)}
        graphs = {gid: pool[gid] for gid in picks.values()}
        owners = {gid: all_owners[gid] for gid in graphs}
        # single writer (host a) mutates one graph it owns (owner repair)
        # and one the peer owns (non-owner rebind)
        for gid, g in list(graphs.items()):
            delta = _delta(g, seed=42)
            graphs[gid] = delta.apply(g)
            info = a.mutate(gid, delta).result(timeout=60)
            assert info["version"] == 1
        for gid in graphs:
            assert a._keys[gid] == b._keys[gid]
            assert a._versions[gid] == b._versions[gid] == 1
            assert a.directory.place(a._keys[gid]).host == owners[gid]
            assert b.directory.place(b._keys[gid]).host == owners[gid]
        assert a.mutation_broadcasts == 2
        assert b.remote_mutations == 2
        assert a.mutation_broadcast_failures == 0
        # the owner repaired (or rebuilt) each plan exactly once
        assert (a.plan_repairs + a.plan_rebuilds
                + b.plan_repairs + b.plan_rebuilds) == 2
        # both hosts serve the POST-delta graphs (forwarding included)
        for eng in (a, b):
            for gid, g in graphs.items():
                x = rng.normal(size=(g.n_cols, 4)).astype(np.float32)
                out = eng.submit(gid, torch.from_numpy(x)).result(timeout=60)
                np.testing.assert_allclose(out.numpy(), _dense(g) @ x,
                                           atol=1e-3, rtol=1e-3)
        assert a.stats()["fleet_forwarded"] + b.stats()["fleet_forwarded"] \
            >= 2
    finally:
        a.close()
        b.close()


def test_multihost_version_fork_guard():
    """Two writers racing the same graph must not silently diverge: a
    replayed broadcast against the wrong base version raises."""
    from repro.core.graph import gcn_normalize
    a, b = _two_host_engines()
    try:
        g = _port(gcn_normalize(make_powerlaw_csr(n=50, seed=1)))
        a.register_graph("g", g)
        b.register_graph("g", g)
        delta = _delta(g, seed=3)
        a.mutate("g", delta).result(timeout=60)   # both hosts now at v1
        assert b.graph_version("g") == 1
        with pytest.raises(RuntimeError, match="fork"):
            b._apply_deltas_local("g", [_delta(delta.apply(g), seed=4)],
                                  expect_base=0)  # stale writer base
        # the stale replay through the data plane fails the same way
        with pytest.raises(RuntimeError, match="fork"):
            a.peers[1].request("mutate", {"graph_id": "g",
                                          "deltas": [delta],
                                          "base_version": 0})
    finally:
        a.close()
        b.close()


def test_stats_keys_match_the_reference_engine():
    """The multihost engine's ``fleet_*`` and ``fleet_dir_*`` stats keys
    are the reference's (plus the port's ``slot_routed_*``)."""
    import jax
    from repro.distributed.multihost import MultihostContext as RefContext
    from repro.serve.fleet import MultihostGraphEngine as RefEngine
    devs = list(jax.local_devices())
    ref = RefEngine(context=RefContext(0, 1, None, devs, devs),
                    serve_port=0, peer_addresses={}, backend="blocked")
    port = MultihostGraphEngine(
        context=initialize_multihost(num_processes=1, device="cpu",
                                     n_local_slots=1),
        serve_port=0, peer_addresses={}, backend="blocked")
    try:
        want = {k for k in ref.stats() if k.startswith("fleet_")}
        got = {k for k in port.stats() if k.startswith("fleet_")}
        assert got == want
    finally:
        ref.close()
        port.close()


# --------------------------------------------------------- frontier exchange
_EXCHANGE_WORKER = textwrap.dedent("""
    import json, os, sys, threading
    sys.path.insert(0, "src")
    import numpy as np
    from repro_torch.data.graphs import make_power_law_graph
    from repro_torch.distributed.multihost import (
        FrontierExchange, PeerClient, PeerServer, peer_ports,
    )
    from repro_torch.sampling import (
        GraphStore, PartitionedStoreClient, sample_frontier,
    )

    rank = int(os.environ["REPRO_MH_PID"])
    nprocs = int(os.environ["REPRO_MH_NPROCS"])
    ports = peer_ports()
    want = json.loads(os.environ["MH_WANT_KEYS"])

    full = GraphStore.build(make_power_law_graph(400, 2400, seed=0),
                            normalize=True)
    shards = full.partition(nprocs)
    bounds = [s.node_range[0] for s in shards] + [full.n_nodes]

    server = PeerServer(ports[rank], process_index=rank, epoch=0,
                        n_devices=1)
    FrontierExchange.serve(server, shards[rank])
    done = threading.Event()
    server.register("peer-done", lambda _p: done.set())

    peers = {r: PeerClient(("127.0.0.1", p), process_index=rank)
             for r, p in ports.items() if r != rank}
    exchange = FrontierExchange(peers)
    client = PartitionedStoreClient(shards[rank], bounds,
                                    exchange.remote_map(), rank)

    seeds = np.array([3, 197, 202, 396])
    keys = []
    for fanouts in ([None, None], [3, 3]):
        fp = sample_frontier(client.sample_in_neighbors, seeds, fanouts,
                             seed=7)
        keys.append(fp.content_key())

    for peer in peers.values():
        peer.request("peer-done", None)
    assert done.wait(60), "peer never finished sampling"
    for peer in peers.values():
        peer.close()
    server.close()
    print(json.dumps({"rank": rank, "parity": keys == want,
                      "remote_edges": int(client.remote_edges),
                      "local_edges": int(client.local_edges),
                      "failovers": exchange.failovers,
                      "requests": exchange.requests}))
""")


def test_cross_partition_exchange_two_processes():
    """Two processes each own half the store; both sample frontiers
    straddling the boundary through ``FrontierExchange`` and must match
    the reference's monolithic sampler bit for bit, with zero
    failovers."""
    from repro.data.graphs import make_power_law_graph
    from repro.sampling import GraphStore, sample_frontier
    full = GraphStore.build(make_power_law_graph(400, 2400, seed=0),
                            normalize=True)
    seeds = np.array([3, 197, 202, 396])
    want = [sample_frontier(full.sample_in_neighbors, seeds, fanouts,
                            seed=7).content_key()
            for fanouts in ([None, None], [3, 3])]
    records = run_fleet(_EXCHANGE_WORKER, num_processes=2, n_local_slots=1,
                        device="cpu", timeout_s=FLEET_TIMEOUT_S,
                        cwd=REPO_ROOT,
                        extra_env={"MH_WANT_KEYS": json.dumps(want)})
    assert len(records) == 2
    for rec in sorted(records, key=lambda r: r["rank"]):
        assert rec["parity"], f"rank {rec['rank']} lost sampling parity"
        assert rec["remote_edges"] > 0
        assert rec["failovers"] == 0
        assert rec["requests"] > 0


def test_run_fleet_raises_with_the_failing_rank():
    src = textwrap.dedent("""
        import os, sys, time
        if os.environ["REPRO_MH_PID"] == "1":
            print("rank one failed on purpose", file=sys.stderr)
            sys.exit(3)
        time.sleep(60)        # a peer that would wait for rank 1
    """)
    with pytest.raises(RuntimeError, match="rank 1 exited 3"):
        run_fleet(src, num_processes=2, n_local_slots=1, device="cpu",
                  timeout_s=FLEET_TIMEOUT_S, cwd=REPO_ROOT)


def test_run_fleet_starts_again_after_a_bind_race(tmp_path):
    """A rank whose port was taken (the race ``free_port`` leaves open)
    fails its first fleet; the harness starts the fleet once more on fresh
    ports. A second race is an error."""
    src = textwrap.dedent("""
        import json, os, sys
        marker = os.path.join(os.environ["MH_DIR"],
                              os.environ["REPRO_MH_PID"])
        n = len(os.listdir(os.environ["MH_DIR"]))
        open(marker + f".{n}", "w").close()
        if os.environ["REPRO_MH_PID"] == "0" and n < int(
                os.environ["MH_RACES"]):
            sys.exit("OSError: [Errno 98] Address already in use")
        print(json.dumps({"rank": int(os.environ["REPRO_MH_PID"]),
                          "ports": os.environ["REPRO_MH_PEER_PORTS"]}))
    """)
    d1 = tmp_path / "once"
    d1.mkdir()
    recs = run_fleet(src, num_processes=1, n_local_slots=1, device="cpu",
                     timeout_s=FLEET_TIMEOUT_S, cwd=REPO_ROOT,
                     extra_env={"MH_DIR": str(d1), "MH_RACES": "1"})
    assert recs[0]["rank"] == 0 and len(os.listdir(d1)) == 2
    d2 = tmp_path / "twice"
    d2.mkdir()
    with pytest.raises(RuntimeError, match="already in use"):
        run_fleet(src, num_processes=1, n_local_slots=1, device="cpu",
                  timeout_s=FLEET_TIMEOUT_S, cwd=REPO_ROOT,
                  extra_env={"MH_DIR": str(d2), "MH_RACES": "2"})


def test_run_cpu_fleet_is_run_fleet_on_cpu_slots():
    """The reference's harness name, with its signature: the same records
    as ``run_fleet(..., device="cpu")`` for a worker that reports what the
    harness handed it."""
    import inspect
    assert inspect.signature(run_cpu_fleet) == \
        inspect.signature(ref_mh.run_cpu_fleet)
    src = textwrap.dedent("""
        import json, os
        print(json.dumps({k: os.environ.get(k) for k in (
            "REPRO_MH_PID", "REPRO_MH_NPROCS", "REPRO_MH_SLOTS",
            "REPRO_MH_DEVICE", "REPRO_MH_EPOCH", "MH_EXTRA")}))
    """)
    kw = dict(num_processes=2, timeout_s=FLEET_TIMEOUT_S,
              extra_env={"MH_EXTRA": "x"}, cwd=REPO_ROOT)
    got = run_cpu_fleet(src, n_local_devices=3, **kw)
    want = run_fleet(src, n_local_slots=3, device="cpu", **kw)
    assert got == want
    assert [r["REPRO_MH_PID"] for r in got] == ["0", "1"]
    assert {(r["REPRO_MH_SLOTS"], r["REPRO_MH_DEVICE"], r["MH_EXTRA"])
            for r in got} == {("3", "cpu", "x")}
