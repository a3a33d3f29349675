"""ComputeTransform service and its client: counterpart of
`vfmreg_tpu/pipeline/transform_server.py` (the reference's ROS1
`ComputeTransform.srv`, `ros/ros1/ComputeTransform.cpp:19-64`, backed by
`KissICP::ComputeTransform`, `KissICP.cpp:39-67`: voxelize both frames, a
local map from frame_b, register frame_a on the XD path with sigma = 1),
as newline-delimited JSON over TCP. The registration runs on the server's
device (default: the card).

  request: {"frame_a": [[x, y, z, ...descriptors], ...],
            "frame_b": [...], "initial_guess": [[4 x 4]]}
  reply:   {"transform": [[4 x 4]], "status": "ok"}

    python -m vfmreg_tpu_torch.pipeline.transform_server [--port 8765] [--device cpu]
"""

from __future__ import annotations

import json
import socket
import socketserver
import threading
from typing import Optional

import numpy as np

from vfmreg_tpu_torch.config import load_config
from vfmreg_tpu_torch.kiss.mapping import VoxelHashMap
from vfmreg_tpu_torch.kiss.registration import register_frame
from vfmreg_tpu_torch.kiss.voxelization import voxel_down_sample
from vfmreg_tpu_torch.utils.device import resolve_device


def compute_transform(
    frame_a: np.ndarray,
    frame_b: np.ndarray,
    initial_guess: Optional[np.ndarray] = None,
    voxel_size: Optional[float] = None,
    max_range: float = 100.0,
    max_points_per_voxel: int = 20,
    device=None,
) -> np.ndarray:
    """`KissICP::ComputeTransform` (`KissICP.cpp:39-67`): double voxelize both
    frames, map <- frame_b, register frame_a with sigma = 1; the pose [4, 4]
    f64 of frame_a in frame_b's frame."""
    config = load_config(None, deskew=False, max_range=max_range)
    if voxel_size is None:
        voxel_size = config.mapping.voxel_size
    if initial_guess is None:
        initial_guess = np.eye(4)

    def voxelize(frame):
        down = voxel_down_sample(frame, voxel_size * 0.5)
        return voxel_down_sample(down, voxel_size * 1.5), down

    source_a, _ = voxelize(np.asarray(frame_a))
    _, down_b = voxelize(np.asarray(frame_b))

    local_map = VoxelHashMap(voxel_size, max_range, max_points_per_voxel, device=device)
    local_map.update(down_b, np.eye(4))

    sigma = 1.0  # `KissICP.cpp:55`
    return np.asarray(
        register_frame(
            points=source_a,
            voxel_map=local_map,
            initial_guess=initial_guess,
            max_correspondance_distance=3.0 * sigma,
            kernel=sigma / 3.0,
            # The reference service registers through the XD overload
            # (`KissICP.cpp:58-63`, `Registration.cpp:384-422`), never VFM-ICP:
            # descriptor columns weigh the champion search.
            force_xd=True,
        )
    )


class _Handler(socketserver.StreamRequestHandler):
    def handle(self):
        for line in self.rfile:
            line = line.strip()
            if not line:
                continue
            try:
                req = json.loads(line)
                pose = compute_transform(
                    np.asarray(req["frame_a"], dtype=np.float64),
                    np.asarray(req["frame_b"], dtype=np.float64),
                    np.asarray(req["initial_guess"], dtype=np.float64)
                    if "initial_guess" in req
                    else None,
                    device=self.server.device,
                )
                reply = {"status": "ok", "transform": pose.tolist()}
            except Exception as e:  # report errors to the client, keep serving
                reply = {"status": "error", "message": f"{type(e).__name__}: {e}"}
            self.wfile.write((json.dumps(reply) + "\n").encode())
            self.wfile.flush()


class TransformServer:
    """Threaded TCP server; `with TransformServer(port) as s:` or `.serve_forever()`."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, device=None):
        resolve_device(device)  # no card: fail here, not per request
        self._server = socketserver.ThreadingTCPServer((host, port), _Handler)
        self._server.device = device
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def request_transform(
    host: str, port: int, frame_a, frame_b, initial_guess=None, timeout: float = 600.0
) -> np.ndarray:
    """Client helper for the service."""
    req = {"frame_a": np.asarray(frame_a).tolist(), "frame_b": np.asarray(frame_b).tolist()}
    if initial_guess is not None:
        req["initial_guess"] = np.asarray(initial_guess).tolist()
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall((json.dumps(req) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = sock.recv(1 << 20)
            if not chunk:
                break
            buf += chunk
    reply = json.loads(buf.decode())
    if reply.get("status") != "ok":
        raise RuntimeError(reply.get("message", "transform service error"))
    return np.asarray(reply["transform"])


def main():
    import argparse

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = parser.parse_args()
    server = TransformServer(args.host, args.port, device=args.device)
    print(f"ComputeTransform service on {server.host}:{server.port}")
    server._server.serve_forever()


if __name__ == "__main__":
    main()
