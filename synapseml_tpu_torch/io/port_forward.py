"""Port forwarding helpers (reference: io/http/PortForwarding.scala).

The reference uses JSch to open a REVERSE ssh tunnel (remote cluster
port → the driver's local serving port) so cloud notebooks can reach a
serving endpoint behind NAT.  The analogue here drives the system
``ssh`` binary (no JSch; zero extra dependencies) with the same
behavior: identity files, StrictHostKeyChecking disabled, and a retry
walk over a remote port range.  A pure-Python :class:`TcpRelay` covers
the local-forwarding/testing half without any ssh daemon.  The PyTorch
port's copy of the JAX package's ``io/port_forward.py``.
"""

from __future__ import annotations

import socket
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["ForwardSession", "TcpRelay", "build_ssh_command",
           "forward_port_to_remote"]


def build_ssh_command(username: str, ssh_host: str, ssh_port: int,
                      bind_address: str, remote_port: int,
                      local_host: str, local_port: int,
                      key_file: Optional[str] = None,
                      timeout_s: float = 10.0) -> List[str]:
    """The ``ssh -N -R`` command line for one reverse-forward attempt —
    split out so tests can pin the exact invocation without an sshd."""
    cmd = ["ssh", "-N", "-p", str(ssh_port),
           "-o", "StrictHostKeyChecking=no",
           "-o", "ExitOnForwardFailure=yes",
           "-o", f"ConnectTimeout={max(1, int(timeout_s))}",
           "-R", f"{bind_address}:{remote_port}:{local_host}:{local_port}"]
    if key_file:
        cmd += ["-i", key_file]
    cmd.append(f"{username}@{ssh_host}")
    return cmd


@dataclass
class ForwardSession:
    """A live reverse tunnel: the ssh child process + the remote port it
    bound.  ``close()`` tears the tunnel down."""
    process: subprocess.Popen
    remote_port: int

    def close(self) -> None:
        if self.process.poll() is None:
            self.process.terminate()
            try:
                self.process.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.process.kill()

    def __enter__(self) -> "ForwardSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def forward_port_to_remote(username: str, ssh_host: str,
                           remote_port_start: int, local_port: int,
                           ssh_port: int = 22, bind_address: str = "*",
                           local_host: str = "0.0.0.0",
                           key_file: Optional[str] = None,
                           max_retries: int = 3,
                           timeout_s: float = 10.0,
                           settle_s: float = 1.0) -> ForwardSession:
    """Open a reverse ssh tunnel ``remote:port → local_host:local_port``,
    walking ``remote_port_start + attempt`` like the reference until one
    binds (ExitOnForwardFailure makes a taken port exit immediately).

    An attempt counts as bound only after surviving the WHOLE
    ``timeout_s + settle_s`` window — a still-connecting ssh must not be
    mistaken for a live tunnel (the forward failure only surfaces after
    the connect completes).  Raises RuntimeError when no port binds."""
    last_err = ""
    for attempt in range(max_retries + 1):
        port = remote_port_start + attempt
        cmd = build_ssh_command(username, ssh_host, ssh_port, bind_address,
                                port, local_host, local_port, key_file,
                                timeout_s)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE)
        except FileNotFoundError:
            raise RuntimeError(
                "port forwarding needs the system 'ssh' binary on PATH "
                "(none found); for a local relay without ssh use TcpRelay")
        # -N never exits on success; an exit inside the window means the
        # connect or the forward bind failed
        deadline = time.monotonic() + timeout_s + settle_s
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(min(0.1, max(settle_s, 0.01)))
        if proc.poll() is None:
            # long-lived ssh with an undrained stderr PIPE blocks once
            # the OS buffer fills — drain it forever on a daemon thread,
            # discarding each chunk (no list that grows an element per
            # 64 KB for the tunnel's lifetime)
            def _drain(s=proc.stderr):
                for _ in iter(lambda: s.read(65536), b""):
                    pass
            threading.Thread(target=_drain, daemon=True).start()
            return ForwardSession(proc, port)
        last_err = (proc.stderr.read() or b"").decode(errors="replace")
    raise RuntimeError(
        f"could not bind a remote port in [{remote_port_start}, "
        f"{remote_port_start + max_retries}]: {last_err.strip()}")


class TcpRelay:
    """Pure-Python local port relay: listen on (host, port) and pipe
    every connection to ``target`` — the in-process stand-in for a
    forwarded port (and the testable half of the tunnel story: an ssh
    -L/-R hop is exactly this relay over a secure channel)."""

    def __init__(self, target: Tuple[str, int], host: str = "127.0.0.1",
                 port: int = 0):
        self.target = target
        self._srv = socket.create_server((host, port))
        self._srv.settimeout(0.2)
        self.address = self._srv.getsockname()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._open: List[socket.socket] = []     # live sockets, pruned
        self._accept_thread = threading.Thread(target=self._accept,
                                               daemon=True)
        self._accept_thread.start()

    @property
    def port(self) -> int:
        return self.address[1]

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # connect + pipe on a per-connection thread so one slow
            # upstream cannot head-of-line-block new accepts
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        try:
            upstream = socket.create_connection(self.target, timeout=10)
        except OSError:
            conn.close()
            return
        with self._lock:
            if self._stop.is_set():
                conn.close()
                upstream.close()
                return
            self._open += [conn, upstream]
        t = threading.Thread(target=self._pipe, args=(upstream, conn),
                             daemon=True)
        t.start()
        self._pipe(conn, upstream)
        t.join()
        with self._lock:
            for s in (conn, upstream):
                if s in self._open:
                    self._open.remove(s)
                try:
                    s.close()
                except OSError:
                    pass

    @staticmethod
    def _pipe(src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(65536)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            for s, how in ((dst, socket.SHUT_WR), (src, socket.SHUT_RD)):
                try:
                    s.shutdown(how)
                except OSError:
                    pass

    def close(self) -> None:
        """Stop accepting AND drop every live connection — a torn-down
        tunnel must revoke access, exactly like an ssh forward
        teardown."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            live, self._open = self._open, []
        for s in live:
            # shutdown BEFORE close: a bare close of a socket another
            # thread is blocked in recv() on neither wakes that thread
            # nor reliably sends the FIN
            for fn in (lambda: s.shutdown(socket.SHUT_RDWR), s.close):
                try:
                    fn()
                except OSError:
                    pass

    def __enter__(self) -> "TcpRelay":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
