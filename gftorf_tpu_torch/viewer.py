"""Live network viewer speaking the SIBR remote-viewer socket protocol.

The port's copy of ``gftorf_tpu/viewer.py`` (numpy and the standard
library). ``render_fn`` may return the JAX package's (H, W, 3) numpy
image or, as the port's renderer gives it (``renderer.render(...)
["render"]``), a (3, H, W) torch tensor on any device.

Wire format (fixed by the SIBR client, same protocol as the reference's
gaussian_renderer/network_gui.py — the reference keeps its training-loop
hook commented out, train.py:131-144):

  client -> server : u32-LE length | JSON camera/settings message
  server -> client : raw RGB8 frame bytes (optional) |
                     u32-LE length | verify string (ascii)

The JSON view/projection matrices arrive in the SIBR convention; the
sign flips on the y/z columns below convert them to ours and are part of
the protocol, not of the reference implementation.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
from typing import Callable, Optional

import numpy as np

_LEN = struct.Struct("<I")


@dataclasses.dataclass
class ViewRequest:
    """One decoded client message."""

    width: int
    height: int
    do_training: bool = True
    keep_alive: bool = True
    scaling_modifier: float = 1.0
    convert_shs_python: bool = False
    compute_cov3d_python: bool = False
    fov_y: float = 0.0
    fov_x: float = 0.0
    z_near: float = 0.01
    z_far: float = 100.0
    world_view: Optional[np.ndarray] = None  # (4, 4)
    full_proj: Optional[np.ndarray] = None  # (4, 4)

    @property
    def wants_frame(self) -> bool:
        return self.width > 0 and self.height > 0

    @staticmethod
    def from_json(msg: dict) -> "ViewRequest":
        req = ViewRequest(width=msg["resolution_x"],
                          height=msg["resolution_y"])
        if not req.wants_frame:
            return req

        def mat(key, flip_cols):
            m = np.asarray(msg[key], np.float32).reshape(4, 4)
            m[:, flip_cols] *= -1.0  # SIBR -> our handedness
            return m

        req.do_training = bool(msg["train"])
        req.keep_alive = bool(msg["keep_alive"])
        req.scaling_modifier = float(msg["scaling_modifier"])
        req.convert_shs_python = bool(msg["shs_python"])
        req.compute_cov3d_python = bool(msg["rot_scale_python"])
        req.fov_y, req.fov_x = msg["fov_y"], msg["fov_x"]
        req.z_near, req.z_far = msg["z_near"], msg["z_far"]
        req.world_view = mat("view_matrix", [1, 2])
        req.full_proj = mat("view_projection_matrix", [1])
        return req


def _hwc_image(img) -> np.ndarray:
    """A render as an (H, W, 3) numpy array: numpy images pass as they
    are, torch tensors are (3, H, W) and come to the host."""
    if isinstance(img, np.ndarray):
        return img
    return img.detach().movedim(0, -1).cpu().numpy()


class ViewerServer:
    """Non-blocking accept loop + per-message render/reply."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host, self.port = host, port
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    # -- framing ------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            c = self.conn.recv(n)
            if not c:
                raise ConnectionError("viewer closed")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def recv_request(self) -> ViewRequest:
        (length,) = _LEN.unpack(self._recv_exact(_LEN.size))
        return ViewRequest.from_json(
            json.loads(self._recv_exact(length).decode("utf-8"))
        )

    def send_frame(self, frame: Optional[bytes], verify: str) -> None:
        if frame is not None:
            self.conn.sendall(frame)
        self.conn.sendall(_LEN.pack(len(verify)))
        self.conn.sendall(verify.encode("ascii"))

    # -- loop hook ----------------------------------------------------
    def poll(self) -> None:
        if self.conn is None:
            try:
                self.conn, addr = self.listener.accept()
                self.conn.settimeout(None)
                print(f"\nviewer connected: {addr}")
            except (BlockingIOError, OSError):
                pass

    def serve_step(self, render_fn: Callable[[ViewRequest], np.ndarray],
                   verify: str) -> bool:
        """Handle pending viewer messages; render_fn(req) returns a float
        image in [0, 1], (H, W, 3) numpy or (3, H, W) torch. Returns True
        to keep training."""
        self.poll()
        while self.conn is not None:
            try:
                req = self.recv_request()
                frame = None
                if req.wants_frame:
                    img = np.clip(_hwc_image(render_fn(req)), 0.0, 1.0)
                    frame = (img * 255.0).astype(np.uint8).tobytes()
                self.send_frame(frame, verify)
                if req.do_training or not req.keep_alive:
                    break
            except Exception as e:
                # Close (not just drop) the socket and surface the cause:
                # a render_fn bug would otherwise be indistinguishable
                # from a client disconnect.
                print(f"viewer: connection dropped ({type(e).__name__}: {e})",
                      flush=True)
                try:
                    self.conn.close()
                except OSError:
                    pass
                self.conn = None
        return True


# ------------------------------------------------------------------
# Module-level convenience mirroring the reference entry points.
_server: Optional[ViewerServer] = None


def init(wish_host: str = "127.0.0.1", wish_port: int = 6009) -> None:
    global _server
    _server = ViewerServer(wish_host, wish_port)


def serve_step(render_fn, source_path: str) -> bool:
    if _server is None:
        return True
    return _server.serve_step(
        lambda req: render_fn(dataclasses.asdict(req)), source_path
    )
