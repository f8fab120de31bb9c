"""Multi-host fleet bootstrap + the forwarding data plane.

Three concerns, one module:

* **Rendezvous** — :func:`initialize_multihost` joins this process to a
  ``torch.distributed`` process group (backend ``gloo``, a TCP coordinator,
  an explicit timeout so a lost peer fails instead of hanging) and returns
  a :class:`MultihostContext` with the fleet's slots: this process's local
  slots (``torch.device``s, which may repeat one card, as in
  :func:`~repro_torch.launch.mesh.graph_mesh`) and the global slots,
  ``(process_index, local_slot)`` pairs in process-major order. gloo is the
  backend on the card too: NCCL refuses two ranks on one GPU, and gloo
  carries the one collective the fleet needs (the host-staged gather of
  ``serve_global``'s partials).

* **Data plane** — serving forwards *requests*, not collectives: a request
  admitted on host A for a plan owned by host B travels over a plain TCP
  channel (:class:`PeerServer` / :class:`PeerClient`, length-prefixed
  pickled frames) and the answer comes back the same way. Frames carry
  numpy arrays and plain containers, never a ``torch.Tensor`` (a pickled
  CUDA tensor would tie the frame to a device the peer may not have), and
  the wire format is the reference's byte for byte. Collectives only enter
  for the explicitly-collective global dispatch
  (``MultihostGraphEngine.serve_global``). The channels carry a ``hello``
  handshake exchanging ``(process_index, epoch)`` so the placement
  directory learns about restarts. The transport trusts its peers (it is an
  intra-fleet protocol on a private interconnect) — do not expose the ports
  publicly.

* **Harness** — :func:`run_fleet` spawns N fresh ``python -c`` workers
  (never ``fork``: a forked CUDA context is unusable), wired together with
  a free coordinator port and a peer-port table published via
  ``REPRO_MH_*`` env vars, with ``REPRO_MH_SLOTS`` local slots of
  ``REPRO_MH_DEVICE`` each. Workers call :func:`initialize_multihost` with
  no arguments (env-driven) and print a final JSON line; the harness
  returns one parsed record per rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.plan_cache import DeviceLike, resolve_device
from ..launch.mesh import graph_mesh, resolve_slots

__all__ = [
    "MultihostContext",
    "initialize_multihost",
    "peer_ports",
    "PeerServer",
    "PeerClient",
    "FrontierExchange",
    "free_port",
    "run_fleet",
    "run_cpu_fleet",
]

# env vars the harness publishes to its worker subprocesses
_ENV_COORD = "REPRO_MH_COORD"
_ENV_NPROCS = "REPRO_MH_NPROCS"
_ENV_PID = "REPRO_MH_PID"
_ENV_PEER_PORTS = "REPRO_MH_PEER_PORTS"
_ENV_EPOCH = "REPRO_MH_EPOCH"
_ENV_SLOTS = "REPRO_MH_SLOTS"
_ENV_DEVICE = "REPRO_MH_DEVICE"

GlobalSlot = Tuple[int, int]       # (process_index, local slot index)


@dataclasses.dataclass
class MultihostContext:
    """One process's view of the fleet after rendezvous."""

    process_index: int
    process_count: int
    coordinator: Optional[str]
    local_devices: List[torch.device]
    global_devices: List[GlobalSlot]
    epoch: int = 0

    @property
    def n_local_devices(self) -> int:
        return len(self.local_devices)

    @property
    def n_global_devices(self) -> int:
        return len(self.global_devices)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         *, epoch: Optional[int] = None,
                         device: DeviceLike = None,
                         n_local_slots: Optional[int] = None,
                         timeout_s: float = 120.0) -> MultihostContext:
    """Rendezvous this process into the fleet; env-driven when arguments are
    omitted (the harness publishes ``REPRO_MH_*``).

    The local slots are ``n_local_slots`` (or ``REPRO_MH_SLOTS``) copies of
    ``device`` (or ``REPRO_MH_DEVICE``), else :func:`graph_mesh` on that
    device type. ``device`` defaults to ``cuda`` and raises without it: pass
    ``device="cpu"`` for CPU slots. A single-process fleet (``num_processes``
    absent or 1) starts no process group — the engine layers all treat that
    as the one-host case. Otherwise every process joins a gloo group at
    ``tcp://<coordinator>`` with ``timeout_s`` on the rendezvous and every
    collective, and the processes exchange their slot counts once.
    """
    coordinator_address = coordinator_address or os.environ.get(_ENV_COORD)
    if num_processes is None:
        num_processes = int(os.environ.get(_ENV_NPROCS, "1"))
    if process_id is None:
        process_id = int(os.environ.get(_ENV_PID, "0"))
    if epoch is None:
        epoch = int(os.environ.get(_ENV_EPOCH, "0"))
    if device is None:
        device = os.environ.get(_ENV_DEVICE) or None
    if n_local_slots is None and os.environ.get(_ENV_SLOTS):
        n_local_slots = int(os.environ[_ENV_SLOTS])
    if n_local_slots is None:
        local = graph_mesh(device=device)
    else:
        local = resolve_slots([resolve_device(device)] * int(n_local_slots))

    if num_processes <= 1:
        return MultihostContext(
            process_index=process_id, process_count=max(1, num_processes),
            coordinator=coordinator_address, local_devices=local,
            global_devices=[(process_id, i) for i in range(len(local))],
            epoch=epoch)
    if coordinator_address is None:
        raise ValueError(
            f"multi-process fleet ({num_processes} processes) needs a "
            f"coordinator address (or {_ENV_COORD} in the environment)")
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
    counts: List[Optional[int]] = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local))
    return MultihostContext(
        process_index=dist.get_rank(),
        process_count=dist.get_world_size(),
        coordinator=coordinator_address,
        local_devices=local,
        global_devices=[(p, i) for p, n in enumerate(counts)
                        for i in range(int(n))],
        epoch=epoch,
    )


def peer_ports() -> Dict[int, int]:
    """The harness-published ``rank -> data-plane port`` table (env-driven)."""
    raw = os.environ.get(_ENV_PEER_PORTS, "")
    if not raw:
        return {}
    return {int(r): int(p)
            for r, p in (pair.split(":") for pair in raw.split(","))}


# --------------------------------------------------------------------------
# framed transport (the reference's wire format)
# --------------------------------------------------------------------------
_FRAME_HDR = struct.Struct(">Q")
_MAX_FRAME = 1 << 31      # 2 GiB: a corrupted header must not OOM the host


def _send_frame(sock: socket.socket, obj: Any) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_FRAME_HDR.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed the channel mid-frame")
        buf.extend(chunk)
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Any:
    (n,) = _FRAME_HDR.unpack(_recv_exact(sock, _FRAME_HDR.size))
    if n > _MAX_FRAME:
        raise ConnectionError(f"oversized frame ({n} bytes)")
    return pickle.loads(_recv_exact(sock, n))


class PeerServer:
    """Data-plane listener: one daemon accept-loop, one thread per peer
    connection, a handler registry keyed by op name.

    Handlers run on the connection thread and may block (e.g. dispatching a
    forwarded request and waiting on its answer) — each peer connection is
    its own thread, so one slow request never stalls a different peer.
    Handler exceptions travel back as ``("err", traceback)`` frames and
    re-raise caller-side; transport errors surface as ``ConnectionError``
    so the caller can fail the peer over.
    """

    def __init__(self, port: int = 0, *, host: str = "127.0.0.1",
                 process_index: int = 0, epoch: int = 0,
                 n_devices: int = 1):
        self.process_index = process_index
        self.epoch = epoch
        self.n_devices = n_devices
        self._handlers: Dict[str, Callable[[Any], Any]] = {}
        self._lock = threading.Lock()
        self._conn_threads: List[threading.Thread] = []
        self._closing = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self.requests_served = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"peer-server-{self.port}",
            daemon=True)
        self._accept_thread.start()

    def register(self, op: str, fn: Callable[[Any], Any]) -> None:
        with self._lock:
            self._handlers[op] = fn

    def close(self) -> None:
        self._closing = True
        try:
            self._sock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while not self._closing:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return              # listener closed
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True)
            t.start()
            # prune finished handler threads: reconnect-after-reset churn
            # must not grow this list without bound on a long-lived server
            self._conn_threads = [c for c in self._conn_threads
                                  if c.is_alive()]
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            try:
                while True:
                    op, payload = _recv_frame(conn)
                    if op == "hello":
                        _send_frame(conn, ("ok", {
                            "process_index": self.process_index,
                            "epoch": self.epoch,
                            "n_devices": self.n_devices}))
                        continue
                    with self._lock:
                        fn = self._handlers.get(op)
                    if fn is None:
                        _send_frame(conn, ("err", f"unknown op {op!r}"))
                        continue
                    try:
                        result = fn(payload)
                    except Exception:  # noqa: BLE001 — ship to the caller
                        _send_frame(conn, ("err", traceback.format_exc()))
                        continue
                    with self._lock:
                        self.requests_served += 1
                    _send_frame(conn, ("ok", result))
            except (ConnectionError, EOFError, OSError):
                return              # peer went away; its thread ends here
            except Exception:  # noqa: BLE001 — corrupt frame/pickle: drop
                return              # the CONNECTION (socket closes, the
                #                     peer reconnects), never the server


class PeerClient:
    """One host's channel to one peer: lazy connect, ``hello`` handshake,
    one in-flight request per channel (a lock serializes; the engine runs
    one forward task per peer per flush, so this is the natural unit).
    """

    def __init__(self, address: Tuple[str, int], *,
                 process_index: int = 0, epoch: int = 0,
                 timeout_s: float = 120.0, connect_timeout_s: float = 30.0):
        self.address = address
        self.process_index = process_index   # OUR rank (sent in the hello)
        self.epoch = epoch
        self.timeout_s = timeout_s
        self.connect_timeout_s = connect_timeout_s
        self.peer_process: Optional[int] = None
        self.peer_epoch: Optional[int] = None
        self.peer_devices: Optional[int] = None
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def _connect_locked(self) -> socket.socket:
        if self._sock is not None:
            return self._sock
        # fleet processes come up asynchronously: a refused connection
        # usually means the peer has not bound its server YET, so retry
        # with backoff until connect_timeout_s before giving up (a dead
        # peer then surfaces as ConnectionError -> directory eviction)
        deadline = time.monotonic() + self.connect_timeout_s
        delay = 0.05
        while True:
            try:
                sock = socket.create_connection(self.address,  # statics: ignore[blocking-call-under-lock] -- the per-channel mutex intentionally serializes connect + one in-flight request; only forwarders block on it
                                                timeout=self.timeout_s)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(delay)  # statics: ignore[blocking-call-under-lock] -- bounded connect backoff under the same per-channel mutex (see above)
                delay = min(delay * 2, 0.5)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _send_frame(sock, ("hello", {"process_index": self.process_index,
                                     "epoch": self.epoch}))
        status, info = _recv_frame(sock)
        if status != "ok":
            sock.close()
            raise ConnectionError(f"handshake rejected: {info}")
        self.peer_process = int(info["process_index"])
        self.peer_epoch = int(info["epoch"])
        self.peer_devices = int(info.get("n_devices", 1))
        self._sock = sock
        return sock

    def handshake(self) -> Tuple[int, int]:
        """Connect (if needed) and return the peer's ``(rank, epoch)``."""
        with self._lock:
            self._connect_locked()
            return self.peer_process, self.peer_epoch

    def request(self, op: str, payload: Any) -> Any:
        """One round trip; remote handler exceptions re-raise as
        RuntimeError, transport failures as ConnectionError (after which
        the channel is reset so the next request reconnects)."""
        with self._lock:
            sock = self._connect_locked()
            try:
                _send_frame(sock, (op, payload))
                status, result = _recv_frame(sock)
            except (ConnectionError, EOFError, OSError) as e:
                self._reset_locked()
                raise ConnectionError(
                    f"peer {self.address} channel failed: {e}") from e
            if status != "ok":
                raise RuntimeError(f"remote {op!r} failed:\n{result}")
            return result

    def _reset_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def close(self) -> None:
        with self._lock:
            self._reset_locked()


class FrontierExchange:
    """Cross-partition frontier exchange over the peer data plane.

    The sampling layer partitions the graph store into contiguous node
    ranges, one shard per host; sampling a frontier layer then needs the
    in-edges of REMOTE-owned nodes. This class is both ends of that hop:

    * ``serve(server, store)`` registers the ``"sample-hop"`` op on a
      host's :class:`PeerServer`, answering peers' sample requests from
      the local shard (arrays in, arrays out — one round trip per
      (hop, owner) pair, not per node);
    * ``sampler_for(rank)`` wraps a :class:`PeerClient` into the
      ``SampleFn`` shape :class:`~repro_torch.sampling.store.GraphStore`
      uses, ready to drop into a ``PartitionedStoreClient``'s remote map.

    A transport failure counts one failover, then ONE reconnect retry
    (the channel resets itself on error); a second failure raises —
    unlike plan forwarding there is no local fallback, the remote shard
    is the only holder of those rows.
    """

    OP = "sample-hop"

    def __init__(self, peers: "Dict[int, PeerClient]"):
        self.peers = dict(peers)
        self.failovers = 0
        self.requests = 0
        self._lock = threading.Lock()

    @staticmethod
    def serve(server: "PeerServer", store) -> None:
        """Install the remote end: answer sample requests from ``store``
        (anything with the ``sample_in_neighbors`` signature)."""
        def _handle(payload: Dict[str, Any]) -> Dict[str, Any]:
            src, dst, val = store.sample_in_neighbors(
                np.asarray(payload["nodes"], dtype=np.int64),
                payload["fanout"], seed=int(payload["seed"]),
                hop=int(payload["hop"]),
                replace=bool(payload["replace"]))
            return {"src": src, "dst": dst, "val": val}
        server.register(FrontierExchange.OP, _handle)

    def sampler_for(self, rank: int):
        """A ``SampleFn`` that samples on host ``rank``'s shard."""
        client = self.peers[rank]

        def _sample(nodes, fanout=None, *, seed=0, hop=0, replace=False):
            payload = {"nodes": np.asarray(nodes, dtype=np.int64),
                       "fanout": fanout, "seed": seed, "hop": hop,
                       "replace": replace}
            with self._lock:
                self.requests += 1
            try:
                out = client.request(self.OP, payload)
            except ConnectionError:
                with self._lock:
                    self.failovers += 1
                out = client.request(self.OP, payload)  # channel was reset
            return out["src"], out["dst"], out["val"]

        return _sample

    def remote_map(self) -> Dict[int, Any]:
        """``{rank: SampleFn}`` for every connected peer — the ``remote=``
        argument of a ``PartitionedStoreClient``."""
        return {rank: self.sampler_for(rank) for rank in self.peers}


# --------------------------------------------------------------------------
# multi-process harness (tests, chip_smoke.py)
# --------------------------------------------------------------------------
def free_port() -> int:
    """An OS-assigned free TCP port (racy: another process may take it
    before the caller binds it — :func:`run_fleet` retries for that)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_BIND_RACE = ("address already in use", "eaddrinuse")


def run_fleet(worker_src: str, *, num_processes: int = 2,
              n_local_slots: int = 4, device: str = "cuda",
              timeout_s: float = 600.0,
              extra_env: Optional[Dict[str, str]] = None,
              cwd: Optional[str] = None) -> List[Dict]:
    """Spawn ``num_processes`` fresh ``python -c worker_src`` processes.

    Each worker gets ``n_local_slots`` slots of ``device`` (``cuda`` by
    default; the tests pass ``cpu``), the coordinator address, its rank, a
    shared epoch, and the full rank->port table for the forwarding data
    plane, all via ``REPRO_MH_*`` env vars — so the worker body is just::

        ctx = initialize_multihost()          # env-driven
        ... build the engine, serve, and finally ...
        print(json.dumps(record))             # LAST stdout line

    Returns the parsed final JSON line of every rank (rank order). Every
    rank's pipes are drained concurrently. A rank that exits non-zero
    fails the fleet at once (the others are killed) and raises
    RuntimeError with that rank's stderr tail; so does a fleet still
    running after ``timeout_s``. The ports come from :func:`free_port`,
    which can race with other processes (parallel test workers): when a
    failed rank's stderr says its address was in use, the whole fleet is
    started once more on fresh ports.
    """
    try:
        return _run_fleet_once(worker_src, num_processes, n_local_slots,
                               device, timeout_s, extra_env, cwd)
    except _BindRace:
        return _run_fleet_once(worker_src, num_processes, n_local_slots,
                               device, timeout_s, extra_env, cwd)


def run_cpu_fleet(worker_src: str, *, num_processes: int = 2,
                  n_local_devices: int = 4, timeout_s: float = 600.0,
                  extra_env: Optional[Dict[str, str]] = None,
                  cwd: Optional[str] = None) -> List[Dict]:
    """The reference's CPU harness under its own name: :func:`run_fleet`
    with ``n_local_devices`` CPU slots per process."""
    return run_fleet(worker_src, num_processes=num_processes,
                     n_local_slots=n_local_devices, device="cpu",
                     timeout_s=timeout_s, extra_env=extra_env, cwd=cwd)


class _BindRace(RuntimeError):
    pass


def _run_fleet_once(worker_src: str, num_processes: int, n_local_slots: int,
                    device: str, timeout_s: float,
                    extra_env: Optional[Dict[str, str]],
                    cwd: Optional[str]) -> List[Dict]:
    coord_port = free_port()
    ports = {r: free_port() for r in range(num_processes)}
    port_table = ",".join(f"{r}:{p}" for r, p in sorted(ports.items()))
    procs: List[subprocess.Popen] = []
    for rank in range(num_processes):
        env = dict(os.environ)
        env.update({
            _ENV_COORD: f"127.0.0.1:{coord_port}",
            _ENV_NPROCS: str(num_processes),
            _ENV_PID: str(rank),
            _ENV_PEER_PORTS: port_table,
            _ENV_EPOCH: "0",
            _ENV_SLOTS: str(n_local_slots),
            _ENV_DEVICE: str(device),
        })
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", worker_src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=cwd))
    # drain every rank's pipes CONCURRENTLY: waiting on rank 0 while rank
    # 1's pipes sit unread lets rank 1 block on a full pipe buffer
    # mid-collective, wedging rank 0 too — a spurious "hang" with no bug
    outs: List[Optional[Tuple[str, str]]] = [None] * num_processes
    drainers = []
    for rank, p in enumerate(procs):
        t = threading.Thread(
            target=lambda r=rank, pr=p: outs.__setitem__(r, pr.communicate()),
            daemon=True)
        t.start()
        drainers.append(t)
    deadline = time.monotonic() + timeout_s
    failed = timed_out = False
    try:
        while any(t.is_alive() for t in drainers):
            if time.monotonic() >= deadline:
                timed_out = True
                break
            if any(p.poll() not in (None, 0) for p in procs):
                failed = True       # one rank died: its peers would only
                break               # wait for it until their timeouts
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in drainers:     # communicate() returns once the kill lands
            t.join(30.0)

    def tails(n: int) -> str:
        return "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                         f"{o[1][-n:]}" for r, o in enumerate(outs) if o)

    if timed_out:
        raise RuntimeError(f"fleet timed out after {timeout_s}s; rank "
                           f"stderr tails:\n{tails(2000)}")
    for rank, p in enumerate(procs):
        if p.returncode != 0 and not (failed and p.returncode < 0):
            err = outs[rank][1] if outs[rank] else ""
            cls = (_BindRace if any(s in err.lower() for s in _BIND_RACE)
                   else RuntimeError)
            raise cls(f"fleet rank {rank} exited {p.returncode}:\n"
                      f"{err[-4000:]}\n{tails(1000)}")
    if failed:
        raise RuntimeError(f"fleet failed; rank stderr tails:\n{tails(4000)}")
    records = []
    for rank in range(num_processes):
        out = outs[rank][0]
        lines = [ln for ln in out.strip().splitlines() if ln.strip()]
        if not lines:
            raise RuntimeError(f"fleet rank {rank} printed no JSON record")
        records.append(json.loads(lines[-1]))
    return records
