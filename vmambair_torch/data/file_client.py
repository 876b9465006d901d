"""File I/O backends of the port's data layer.

The port's counterpart of `vmambair_tpu/data/file_client.py`: the disk
backend. The lmdb backend and the native `pack` reader (`native/packfile.cc`
behind `vmambair_tpu/data/packfile.py`) are not ported yet and raise.
"""

from __future__ import annotations


class DiskBackend:
    def get(self, filepath: str) -> bytes:
        with open(str(filepath), "rb") as f:
            return f.read()


_NOT_PORTED = {
    "lmdb": "the lmdb backend is not ported to vmambair_torch yet "
            "(ROADMAP.md Queue 1 item 8); use io_backend type 'disk'",
    "pack": "the pack backend (native/packfile.cc) is not ported to "
            "vmambair_torch yet (ROADMAP.md Queue 1 item 8); use io_backend "
            "type 'disk'",
    "memcached": "the memcached backend is not supported",
}


class FileClient:
    """Reads file bytes through a backend named by the YAML `io_backend`
    type; only 'disk' is ported."""

    def __init__(self, backend: str = "disk", **kwargs):
        if backend in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[backend])
        if backend != "disk":
            raise ValueError(f"backend {backend} not supported; choose from "
                             f"['disk', {', '.join(map(repr, _NOT_PORTED))}]")
        self.backend = backend
        self.client = DiskBackend()

    def get(self, filepath, client_key: str = "default") -> bytes:
        return self.client.get(filepath)
