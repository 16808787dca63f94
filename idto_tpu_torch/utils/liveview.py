"""Live trajectory view over a websocket (counterpart of
``idto_tpu/utils/liveview.py``).

A small stdlib-only HTTP + WebSocket (RFC 6455, server to client) server
on localhost: plain HTTP serves the playback viewer of
``utils/playback.py``; each planned trajectory published (every MPC replan)
is streamed to every connected browser as one text frame, and a browser
that connects late gets the last one published.  Client pings are
answered, a close ends the connection, everything else is ignored.

Usage::

    viewer = LiveViewer(model, dt=prob.dt)     # http://localhost:8765
    ...
    viewer.publish(sol.q[0])                   # per replan
    viewer.close()

or ``python -m idto_tpu_torch.examples.run mini_cheetah --mpc --live``.
"""
from __future__ import annotations

import base64
import hashlib
import json
import socket
import struct
import threading
from typing import Optional

import numpy as np

from idto_tpu_torch.models.model import JointType
from idto_tpu_torch.utils.playback import _HTML_TEMPLATE, trajectory_scene_data

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def _ws_accept_key(key: str) -> str:
    digest = hashlib.sha1((key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def _ws_text_frame(payload: bytes) -> bytes:
    """Server->client text frame (FIN, opcode 1, unmasked)."""
    n = len(payload)
    if n < 126:
        head = struct.pack("!BB", 0x81, n)
    elif n < (1 << 16):
        head = struct.pack("!BBH", 0x81, 126, n)
    else:
        head = struct.pack("!BBQ", 0x81, 127, n)
    return head + payload


def _live_html(scene: dict, ws_port: int) -> str:
    """The playback viewer page, bootstrapped with the static scene and a
    websocket client that swaps in each published trajectory."""
    live_js = (
        "<script>(function(){"
        "var ws=new WebSocket('ws://'+location.hostname+':%d/');"
        "ws.onmessage=function(e){var m=JSON.parse(e.data);"
        "SCENE.frames=m.frames;if(m.dt)SCENE.dt=m.dt;"
        "var s=document.getElementById('scrub');"
        "s.max=SCENE.frames.length-1;};"
        "})();</script>" % ws_port
    )
    html = _HTML_TEMPLATE.replace(
        "__TITLE__", "idto_tpu live"
    ).replace("__SCENE_JSON__", json.dumps(scene))
    # The exporter's playback loop reads SCENE.frames.length each tick, so
    # frame-count changes from the stream are picked up automatically.
    return html.replace("</body></html>", live_js + "</body></html>")


class LiveViewer:
    """Threaded HTTP + WebSocket publisher of planned trajectories."""

    def __init__(
        self,
        model,
        dt: float,
        port: int = 8765,
        host: str = "127.0.0.1",
    ):
        if host not in ("127.0.0.1", "localhost", "::1"):
            raise ValueError(f"the live viewer serves localhost only, not "
                             f"{host!r}")
        self._model = model
        self._dt = float(dt)
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._closed = False
        self._last_msg: Optional[bytes] = None

        # Static scene (geoms + one identity-pose frame) for first paint;
        # a neutral quaternion for floating bases keeps FK well-defined.
        q0 = np.zeros(model.nq)
        for j in range(model.num_joints):
            if JointType(model.joint_types[j]) == JointType.FLOATING:
                q0[model.q_starts[j]] = 1.0
        self._scene0 = trajectory_scene_data(model, q0[None], self._dt)

        family = socket.AF_INET6 if host == "::1" else socket.AF_INET
        self._srv = socket.socket(family, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def _serve(self):
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(
                target=self._handle, args=(conn,), daemon=True
            ).start()

    def _handle(self, conn: socket.socket):
        try:
            conn.settimeout(5.0)
            data = b""
            while b"\r\n\r\n" not in data:
                chunk = conn.recv(4096)
                if not chunk:
                    conn.close()
                    return
                data += chunk
            head = data.split(b"\r\n\r\n", 1)[0].decode("latin1")
            headers = {}
            for line in head.split("\r\n")[1:]:
                if ":" in line:
                    k, v = line.split(":", 1)
                    headers[k.strip().lower()] = v.strip()

            if headers.get("upgrade", "").lower() == "websocket":
                accept = _ws_accept_key(headers["sec-websocket-key"])
                conn.sendall(
                    (
                        "HTTP/1.1 101 Switching Protocols\r\n"
                        "Upgrade: websocket\r\n"
                        "Connection: Upgrade\r\n"
                        f"Sec-WebSocket-Accept: {accept}\r\n\r\n"
                    ).encode()
                )
                conn.settimeout(None)
                with self._lock:
                    self._clients.append(conn)
                    last = self._last_msg
                if last is not None:
                    try:
                        conn.sendall(_ws_text_frame(last))
                    except OSError:
                        pass
                self._ws_read_loop(conn)
                return

            # Plain HTTP: serve the viewer page.
            body = _live_html(self._scene0, self.port).encode()
            conn.sendall(
                (
                    "HTTP/1.1 200 OK\r\n"
                    "Content-Type: text/html; charset=utf-8\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n\r\n"
                ).encode()
                + body
            )
            conn.close()
        except Exception:
            try:
                conn.close()
            except OSError:
                pass

    def _ws_read_loop(self, conn: socket.socket):
        """Drain client frames: answer pings, honor close, drop the rest."""
        try:
            while not self._closed:
                head = conn.recv(2)
                if len(head) < 2:
                    break
                opcode = head[0] & 0x0F
                ln = head[1] & 0x7F
                masked = head[1] & 0x80
                if ln == 126:
                    ln = struct.unpack("!H", conn.recv(2))[0]
                elif ln == 127:
                    ln = struct.unpack("!Q", conn.recv(8))[0]
                mask = conn.recv(4) if masked else b""
                payload = b""
                while len(payload) < ln:
                    chunk = conn.recv(ln - len(payload))
                    if not chunk:
                        break
                    payload += chunk
                if masked:
                    payload = bytes(
                        b ^ mask[i % 4] for i, b in enumerate(payload)
                    )
                if opcode == 0x8:  # close
                    break
                if opcode == 0x9:  # ping -> pong
                    conn.sendall(
                        struct.pack("!BB", 0x8A, len(payload)) + payload
                    )
        except OSError:
            pass
        with self._lock:
            if conn in self._clients:
                self._clients.remove(conn)
        try:
            conn.close()
        except OSError:
            pass

    # ------------------------------------------------------------------
    def publish(self, qs, dt: Optional[float] = None) -> None:
        """Broadcast a planned trajectory ``qs`` (T+1, nq; a tensor or an
        array) to all viewers."""
        scene = trajectory_scene_data(self._model, qs, float(dt or self._dt))
        msg = json.dumps(
            {"frames": scene["frames"], "dt": scene["dt"]}
        ).encode()
        with self._lock:
            self._last_msg = msg
            clients = list(self._clients)
        frame = _ws_text_frame(msg)
        for c in clients:
            try:
                c.sendall(frame)
            except OSError:
                with self._lock:
                    if c in self._clients:
                        self._clients.remove(c)

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            for c in self._clients:
                try:
                    c.close()
                except OSError:
                    pass
            self._clients.clear()
