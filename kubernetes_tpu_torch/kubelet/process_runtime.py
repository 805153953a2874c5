"""ProcessRuntime — a real container runtime on the ContainerRuntime seam.

The reference's kubelet drives Docker (ref: pkg/kubelet/dockertools/
docker.go, ~2.5k LoC; infra container kubelet.go:1025). This image has no
container engine, so the real runtime runs pods as **local process groups**:

- the pod sandbox is the native ``pause`` binary (native/pause/pause.cc —
  our C++ rebuild of the reference's x86-64 asm pause, third_party/pause/
  pause.asm) started in its own process group as the pod's PID-1 stand-in;
- each container is ``command + args`` spawned in its own process group
  with the container's env/working dir, stdout+stderr streamed to a
  per-container log file (the json-log analog that containerLogs serves);
- stop is TERM-to-process-group, grace period, then KILL — the same
  escalation Docker's StopContainer performs;
- exec runs the command with the container's environment and returns
  (exit_code, combined output) — the /run//exec and exec-probe path.

"Images" are names only: pull records availability (create fails on an
unpulled image, preserving the kubelet's pull-then-create contract) but
nothing is fetched — the process IS the workload. Pods share the host
network namespace, so the pod IP is 127.0.0.1 and HostPort conflicts are
physical, which is exactly what the scheduler's PodFitsPorts models.

Port of ``kubernetes_tpu/kubelet/process_runtime.py``; the pause binary
is built into the port's own ``kubelet/_build/`` (``BUILD_DIR``).
"""

from __future__ import annotations

import hashlib
import itertools
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api import types as api
from kubernetes_tpu_torch.kubelet.runtime import (
    INFRA_CONTAINER_NAME,
    INFRA_IMAGE,
    ContainerRecord,
    ContainerRuntime,
    build_container_name,
)

__all__ = ["ProcessRuntime", "find_pause_binary", "pause_command", "BUILD_DIR"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# where the port builds the native pause binary: a directory of its own,
# gitignored, shared by every runtime of the checkout (native/ is read,
# never written)
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")


def _build_pause(src: str, out_dir: str) -> Optional[str]:
    """``g++`` ``src`` into ``out_dir/pause-<hash of the source>``, once:
    the binary is written under a temporary name and renamed, so
    kubelets started together each find a whole binary or build their
    own. None if there is no toolchain or the build fails."""
    if not shutil.which("g++"):
        return None
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    out = os.path.join(out_dir, f"pause-{digest}")
    if os.path.isfile(out) and os.access(out, os.X_OK):
        return out
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}"
    try:
        os.makedirs(out_dir, exist_ok=True)
        subprocess.run(["g++", "-Os", "-o", tmp, src],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def find_pause_binary() -> Optional[str]:
    """Locate (or build) the native pause binary, falling back to the
    pure-Python sandbox (native/pause/pause.py) when no binary exists
    and the toolchain is unavailable — the flagship runtime must work in
    toolchain-less environments. Returns the sandbox entry path (binary
    or .py script; see pause_command), or None only if even the Python
    fallback is missing.

    A binary built by ``make`` in native/pause/ is taken first; otherwise
    native/pause/pause.cc is built into ``BUILD_DIR`` (the reference
    builds into a directory of each runtime's)."""
    made = os.path.join(_REPO_ROOT, "native", "pause", "pause")
    if os.path.isfile(made) and os.access(made, os.X_OK):
        return made
    src = os.path.join(_REPO_ROOT, "native", "pause", "pause.cc")
    if os.path.isfile(src):
        built = _build_pause(src, BUILD_DIR)
        if built is not None:
            return built
    fallback = os.path.join(_REPO_ROOT, "native", "pause", "pause.py")
    if os.path.isfile(fallback):
        return fallback
    return None


def pause_command(pause_path: Optional[str]) -> Optional[list]:
    """argv for the sandbox holder: the native binary directly, or the
    Python fallback through this interpreter."""
    if pause_path is None:
        return None
    if pause_path.endswith(".py"):
        return [sys.executable, pause_path]
    return [pause_path]


class _Proc:
    """Book-keeping for one spawned container."""

    def __init__(self, record: ContainerRecord, argv: List[str],
                 env: Dict[str, str], cwd: str, log_path: str):
        self.record = record
        self.argv = argv
        self.env = env
        self.cwd = cwd
        self.log_path = log_path
        self.popen: Optional[subprocess.Popen] = None
        self.stopping = False     # runtime-initiated stop in progress
        self.respawns = 0         # spawn-kill heals (see _refresh)


class ProcessRuntime(ContainerRuntime):
    """Real local-process runtime behind the kubelet's runtime seam."""

    def __init__(self, root_dir: str, pause_binary: Optional[str] = None,
                 stop_grace_s: float = 3.0):
        self.root_dir = root_dir
        self.log_dir = os.path.join(root_dir, "containers")
        os.makedirs(self.log_dir, exist_ok=True)
        self.pause_binary = pause_binary or find_pause_binary()
        # argv the sandbox holder is spawned with (binary, or the Python
        # fallback through sys.executable); identity checks compare argv
        # against this list
        self.pause_cmd = pause_command(self.pause_binary)
        self.stop_grace_s = stop_grace_s
        self._lock = threading.RLock()
        self._procs: Dict[str, _Proc] = {}
        self._images: set = set()
        self._id_counter = itertools.count(1)

    # spawn-kill hardening: some sandboxed environments deliver a stray
    # SIGTERM/SIGKILL to freshly-spawned session leaders (observed in this
    # image: ~50% of new sessions TERM'd within ~1ms of exec, before even a
    # C signal handler can install). A container that died from an external
    # signal this quickly, produced no output, and was not stopped by us is
    # a spawn casualty, not a workload decision — respawn it transparently.
    SPAWN_GUARD_S = 0.2
    SPAWN_RETRIES = 3

    # -- helpers ------------------------------------------------------------
    def _refresh(self, p: _Proc) -> None:
        """Reap and update running state from the real process."""
        if p.popen is None or not p.record.running:
            return
        rc = p.popen.poll()
        if rc is None:
            return
        if (rc in (-signal.SIGTERM, -signal.SIGKILL)
                and not p.stopping
                and p.respawns < self.SPAWN_RETRIES
                and time.time() - p.record.started_at < self.SPAWN_GUARD_S
                and self._log_size(p) == 0):
            p.respawns += 1
            try:
                self._spawn(p)
                return  # still running from the caller's point of view
            except RuntimeError:
                pass
        p.record.running = False
        # children killed by signal surface negative returncodes;
        # docker-style exit codes are 128+signum
        p.record.exit_code = rc if rc >= 0 else 128 - rc
        p.record.finished_at = time.time()

    @staticmethod
    def _log_size(p: _Proc) -> int:
        try:
            return os.path.getsize(p.log_path)
        except OSError:
            return 0

    def _spawn(self, p: _Proc) -> None:
        logf = open(p.log_path, "ab")
        # pause understands the blocked-TERM handshake: it discards one
        # pending stray TERM after installing handlers (pause.cc), so the
        # sandbox holder survives environments that TERM fresh processes.
        # Arbitrary workloads can't be spawned with TERM blocked (most
        # never unblock, which would break graceful stop); they rely on
        # the _refresh spawn-kill heal instead.
        block_term = p.argv == self.pause_cmd
        # Own process group so stop() can killpg the whole container.
        # A fresh pgid within the SAME session — NOT setsid: sandboxed
        # environments may reap processes that escape the supervisor's
        # session. On py3.11+ Popen's process_group=0 does this post-fork
        # without preexec_fn (which CPython documents as unsafe with
        # threads, and the kubelet spawns from many); preexec only carries
        # the pause sandbox's TERM-block handshake there. py3.10 has no
        # process_group kwarg, so the pgid move rides preexec_fn too.
        kwargs = {}
        preexec = None
        if sys.version_info >= (3, 11):
            kwargs["process_group"] = 0
            if block_term:
                def preexec():
                    signal.pthread_sigmask(signal.SIG_BLOCK,
                                           {signal.SIGTERM, signal.SIGINT})
        else:
            def preexec():
                os.setpgid(0, 0)
                if block_term:
                    signal.pthread_sigmask(signal.SIG_BLOCK,
                                           {signal.SIGTERM, signal.SIGINT})
        try:
            p.popen = subprocess.Popen(
                p.argv, stdout=logf, stderr=subprocess.STDOUT,
                stdin=subprocess.DEVNULL, env=p.env, cwd=p.cwd,
                preexec_fn=preexec, **kwargs)
        except OSError as e:
            logf.write(f"start failed: {e}\n".encode())
            logf.close()
            raise RuntimeError(f"cannot start {p.argv[0]!r}: {e}")
        logf.close()  # child holds its own fd
        p.record.running = True
        p.record.started_at = time.time()

    def _snapshot(self, p: _Proc) -> ContainerRecord:
        self._refresh(p)
        return ContainerRecord(**vars(p.record))

    def containers_for_pod(self, pod_uid: str,
                           include_dead: bool = False) -> List[ContainerRecord]:
        with self._lock:
            out = []
            for p in self._procs.values():
                parsed = p.record.parsed
                self._refresh(p)
                if parsed and parsed[3] == pod_uid and \
                        (include_dead or p.record.running):
                    out.append(ContainerRecord(**vars(p.record)))
            return out

    # -- ContainerRuntime ----------------------------------------------------
    def list_containers(self, include_dead: bool = False) -> List[ContainerRecord]:
        with self._lock:
            out = []
            for p in self._procs.values():
                self._refresh(p)
                if include_dead or p.record.running:
                    out.append(ContainerRecord(**vars(p.record)))
            return out

    def create_container(self, pod: api.Pod, container: api.Container,
                         attempt: int) -> str:
        with self._lock:
            if container.image not in self._images:
                raise RuntimeError(f"image not present: {container.image}")
            argv = list(container.command) + list(container.args)
            if not argv:
                # no entrypoint metadata without a real image — hold the
                # slot with a pause process so lifecycle still works
                if self.pause_binary is None:
                    raise RuntimeError(
                        f"container {container.name!r} has no command and "
                        "no pause binary is available")
                argv = list(self.pause_cmd)
            cid = f"p{next(self._id_counter)}"
            env = dict(os.environ)
            for e in container.env:
                env[e.name] = e.value
            record = ContainerRecord(
                id=cid,
                name=build_container_name(pod, container.name, attempt),
                image=container.image, created_at=time.time())
            self._procs[cid] = _Proc(
                record, argv, env, container.working_dir or self.root_dir,
                os.path.join(self.log_dir, f"{cid}.log"))
            return cid

    def create_infra_container(self, pod: api.Pod) -> str:
        with self._lock:
            if self.pause_binary is None:
                raise RuntimeError(
                    "no pause binary: build native/pause (make -C native/pause) "
                    "or install g++")
            cid = f"p{next(self._id_counter)}"
            record = ContainerRecord(
                id=cid,
                name=build_container_name(pod, INFRA_CONTAINER_NAME, 0),
                image=INFRA_IMAGE, created_at=time.time(),
                # host-network model: every pod is reachable on loopback,
                # so HTTP/TCP probes and the service proxy hit real sockets
                ip="127.0.0.1")
            self._procs[cid] = _Proc(
                record, list(self.pause_cmd), dict(os.environ), self.root_dir,
                os.path.join(self.log_dir, f"{cid}.log"))
            return cid

    def start_container(self, container_id: str) -> None:
        with self._lock:
            p = self._procs[container_id]
            if p.record.running:
                return
            p.stopping = False
            self._spawn(p)

    def stop_container(self, container_id: str) -> None:
        with self._lock:
            p = self._procs.get(container_id)
            if p is None or p.popen is None:
                return
            p.stopping = True
            self._refresh(p)
            if not p.record.running:
                return
            pgid = p.popen.pid
            is_pause = p.argv == self.pause_cmd
        # TERM -> grace -> KILL outside the lock (the wait can take seconds).
        # For the pause sandbox only, TERM is re-sent every 0.5s through the
        # grace period: pause may classify one early TERM as a spawn-kill
        # stray and discard it (native/pause/pause.cc), so a single shot
        # could wedge a graceful stop into the KILL path. Ordinary workloads
        # get the Docker-style single TERM — some tools treat a second
        # signal as "force quit now", which would cut their grace short.
        deadline = time.monotonic() + self.stop_grace_s
        terminated = False
        while True:
            try:
                os.killpg(pgid, signal.SIGTERM)
            except ProcessLookupError:
                pass
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                p.popen.wait(timeout=min(0.5, remaining) if is_pause
                             else remaining)
                terminated = True
                break
            except subprocess.TimeoutExpired:
                if not is_pause:
                    break
                continue
        if not terminated and p.popen.poll() is None:
            try:
                os.killpg(pgid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.popen.wait(timeout=5)
        with self._lock:
            self._refresh(p)

    def remove_container(self, container_id: str) -> None:
        self.stop_container(container_id)
        with self._lock:
            p = self._procs.pop(container_id, None)
            if p is not None:
                try:
                    os.unlink(p.log_path)
                except OSError:
                    pass

    def inspect_container(self, container_id: str) -> Optional[ContainerRecord]:
        with self._lock:
            p = self._procs.get(container_id)
            return self._snapshot(p) if p else None

    def pull_image(self, image: str) -> None:
        with self._lock:
            self._images.add(image)

    def list_images(self) -> List[str]:
        with self._lock:
            return sorted(self._images)

    def remove_image(self, image: str) -> None:
        with self._lock:
            self._images.discard(image)

    def group_stats(self, container_id: str):
        """(cpu_seconds, rss_bytes) summed over the container's whole
        process group via /proc, or None when the group is gone — each
        container IS a process group (spawned with a fresh pgid, see
        _spawn), so
        pgrp matching gives the cgroup-equivalent accounting cAdvisor
        would report, including forked children."""
        with self._lock:
            p = self._procs.get(container_id)
            if p is None or p.popen is None:
                return None
            self._refresh(p)
            if not p.record.running:
                return None
            pgid = p.popen.pid
        try:
            hz = float(os.sysconf("SC_CLK_TCK"))
        except (ValueError, OSError):
            hz = 100.0
        cpu = 0.0
        rss = 0
        found = False
        for entry in os.listdir("/proc"):
            if not entry.isdigit():
                continue
            try:
                with open(f"/proc/{entry}/stat") as f:
                    # fields after the parenthesised comm (which may hold
                    # spaces): state, ppid, pgrp, ... utime@11, stime@12
                    rest = f.read().rpartition(")")[2].split()
                if int(rest[2]) != pgid:
                    continue
                found = True
                cpu += (int(rest[11]) + int(rest[12])) / hz
                with open(f"/proc/{entry}/status") as f:
                    for line in f:
                        if line.startswith("VmRSS:"):
                            rss += int(line.split()[1]) * 1024
                            break
            except (OSError, ValueError, IndexError):
                continue  # raced with an exiting group member
        return (cpu, rss) if found else None

    def _exec_target(self, container_id: str):
        """(env, cwd) for a live container, or an error string — shared
        preamble of both exec paths; callers never hold the lock across
        their IO."""
        with self._lock:
            p = self._procs.get(container_id)
            if p is None:
                return None, "no such container"
            self._refresh(p)
            if not p.record.running:
                return None, "container not running"
            return (dict(p.env), p.cwd), ""

    def exec_in_container(self, container_id: str, cmd: List[str]) -> Tuple[int, str]:
        target, err = self._exec_target(container_id)
        if target is None:
            return 1, err
        env, cwd = target
        try:
            r = subprocess.run(cmd, env=env, cwd=cwd, timeout=15,
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT,
                               stdin=subprocess.DEVNULL)
            return r.returncode, r.stdout.decode("utf-8", "replace")
        except subprocess.TimeoutExpired:
            return 124, "exec timed out"
        except OSError as e:
            return 126, f"exec failed: {e}"

    def exec_stream_in_container(self, container_id: str, cmd: List[str]):
        """Live-stream the command's combined output, then the exit code —
        the WebSocket exec path. The process runs with the container's
        environment exactly like exec_in_container. Never yields while
        holding the runtime lock (the consumer's socket write can stall
        arbitrarily), and an abandoned stream kills + reaps the child."""
        target, err = self._exec_target(container_id)
        if target is None:
            yield err.encode()
            yield 1
            return
        env, cwd = target
        try:
            proc = subprocess.Popen(cmd, env=env, cwd=cwd,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT,
                                    stdin=subprocess.DEVNULL)
        except (OSError, ValueError) as e:  # ValueError: NUL in argv etc.
            yield f"exec failed: {e}".encode()
            yield 126
            return
        try:
            assert proc.stdout is not None
            while True:
                chunk = proc.stdout.read1(65536)
                if not chunk:
                    break
                yield chunk
            yield proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            yield 124
        finally:
            # normal exit, timeout, or the consumer abandoning the
            # generator (GeneratorExit): no orphans, no zombies
            if proc.poll() is None:
                proc.kill()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
            proc.stdout.close()

    def container_logs(self, container_id: str, tail: int = 0) -> str:
        with self._lock:
            p = self._procs.get(container_id)
            if p is None:
                return ""
            log_path = p.log_path
        try:
            with open(log_path, "r", errors="replace") as f:
                text = f.read()
        except OSError:
            return ""
        if tail > 0:
            lines = text.splitlines(keepends=True)
            text = "".join(lines[-tail:])
        return text

    # -- lifecycle -----------------------------------------------------------
    def shutdown(self) -> None:
        """Stop every process (harness teardown)."""
        for cid in list(self._procs):
            try:
                self.stop_container(cid)
            except Exception:
                pass
