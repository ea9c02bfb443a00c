"""Native COLMAP reconstruction parser and writer (binary + text), no pycolmap.

Counterpart (a numpy copy) of ``gaussian_splatting_lightning_tpu/data/colmap.py``,
plus ``write_reconstruction``, the binary writer the port's own tools use,
and ``rotmat_to_qvec`` (``scripts/make_synthetic_scene.py``'s).
The reference leans on the pycolmap C++ binding
(``gs_lightning/datasets/colmap_dataset.py:48-52``); the formats are simple,
stable binary layouts, parsed here with ``struct``/numpy.

Format reference: COLMAP src/colmap/scene/reconstruction_io.cc (public docs).
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct
import subprocess
from pathlib import Path

import numpy as np

# model_id -> (name, num_params). Focal-relevant params come first.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),  # f, cx, cy
    1: ("PINHOLE", 4),  # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),  # f, cx, cy, k
    3: ("RADIAL", 5),  # f, cx, cy, k1, k2
    4: ("OPENCV", 8),  # fx, fy, cx, cy, k1, k2, p1, p2
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def fx(self) -> float:
        return float(self.params[0])

    @property
    def fy(self) -> float:
        if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV"):
            return float(self.params[1])
        return float(self.params[0])

    @property
    def cx(self) -> float:
        i = 2 if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV") else 1
        return float(self.params[i])

    @property
    def cy(self) -> float:
        i = 3 if self.model in ("PINHOLE", "OPENCV", "OPENCV_FISHEYE", "FULL_OPENCV") else 2
        return float(self.params[i])


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) wxyz, world->cam rotation
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str

    def cam_from_world(self) -> np.ndarray:
        """(3, 4) [R|t] — same as pycolmap Image.cam_from_world().matrix()."""
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        R = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )
        return np.concatenate([R, self.tvec.reshape(3, 1)], axis=1)

    def camera_center(self) -> np.ndarray:
        m = self.cam_from_world()
        return -m[:, :3].T @ m[:, 3]


@dataclasses.dataclass
class Reconstruction:
    cameras: dict  # camera_id -> ColmapCamera
    images: dict  # image_id -> ColmapImage
    points_xyz: np.ndarray  # (N, 3) f32
    points_rgb: np.ndarray  # (N, 3) f32 in [0, 1]


def _read_binary_cameras(path: Path):
    cameras = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, nparams = CAMERA_MODELS[mid]
            params = np.array(struct.unpack(f"<{nparams}d", f.read(8 * nparams)))
            cameras[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cameras


def _read_binary_images(path: Path):
    images = {}
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            iid = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            (cid,) = struct.unpack("<i", f.read(4))
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (npts,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * npts, 1)  # skip (x, y double, point3D_id int64)
            images[iid] = ColmapImage(iid, qvec, tvec, cid, name.decode("utf-8"))
    return images


_POINTS_LIB = None
_POINTS_TRIED = False


def _load_points_native():
    """C++ points3D.bin reader (native/colmap_points.cpp) — the record is
    variable-length (per-point track), so the Python loop costs minutes at
    the multi-million points of a real MipNeRF-360 reconstruction. Built on
    first use; None when no toolchain (the Python loop remains the
    fallback). The reference gets this for free from pycolmap's C++."""
    global _POINTS_LIB, _POINTS_TRIED
    if _POINTS_TRIED:
        return _POINTS_LIB
    _POINTS_TRIED = True
    root = Path(__file__).resolve().parents[2] / "native"
    so = root / "libgscolmap.so"
    try:
        if not so.exists():
            subprocess.run(
                ["make", "-C", str(root), "libgscolmap.so"],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.gs_colmap_points_count.restype = ctypes.c_int64
    lib.gs_colmap_points_count.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.gs_colmap_points_read.restype = ctypes.c_int
    lib.gs_colmap_points_read.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    _POINTS_LIB = lib
    return _POINTS_LIB


def _read_binary_points(path: Path):
    lib = _load_points_native()
    if lib is not None:
        buf = path.read_bytes()
        n = lib.gs_colmap_points_count(buf, len(buf))
        if n >= 0:
            xyz = np.empty((n, 3), np.float32)
            rgb = np.empty((n, 3), np.float32)
            rc = lib.gs_colmap_points_read(
                buf, len(buf), n,
                xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            )
            if rc == 0:
                return xyz, rgb
        # malformed per the native walker: fall through so the Python
        # loop raises the precise struct error

    xyz_list, rgb_list = [], []
    with open(path, "rb") as f:
        (num,) = struct.unpack("<Q", f.read(8))
        for _ in range(num):
            buf = f.read(43)  # id q + 3d xyz + 3B rgb + d error
            _, x, y, z, r, g, b, _err = struct.unpack("<Q3d3Bd", buf)
            (track_len,) = struct.unpack("<Q", f.read(8))
            f.seek(8 * track_len, 1)
            xyz_list.append((x, y, z))
            rgb_list.append((r, g, b))
    xyz = np.array(xyz_list, np.float32).reshape(-1, 3)
    rgb = np.array(rgb_list, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


def _read_text_cameras(path: Path):
    cameras = {}
    for line in path.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        tok = line.split()
        cid, model, w, h = int(tok[0]), tok[1], int(tok[2]), int(tok[3])
        params = np.array([float(t) for t in tok[4:]])
        cameras[cid] = ColmapCamera(cid, model, w, h, params)
    return cameras


def _read_text_images(path: Path):
    images = {}
    lines = [
        l for l in path.read_text().splitlines()
        if l.strip() and not l.startswith("#")
    ]
    for meta in lines[0::2]:  # every image has a second (points2D) line
        tok = meta.split()
        iid = int(tok[0])
        qvec = np.array([float(t) for t in tok[1:5]])
        tvec = np.array([float(t) for t in tok[5:8]])
        cid = int(tok[8])
        images[iid] = ColmapImage(iid, qvec, tvec, cid, tok[9])
    return images


def _read_text_points(path: Path):
    xyz_list, rgb_list = [], []
    for line in path.read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        tok = line.split()
        xyz_list.append([float(t) for t in tok[1:4]])
        rgb_list.append([float(t) for t in tok[4:7]])
    xyz = np.array(xyz_list, np.float32).reshape(-1, 3)
    rgb = np.array(rgb_list, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


def read_reconstruction(colmap_path) -> Reconstruction:
    """Load cameras/images/points from a COLMAP model dir (bin or txt).

    Accepts the model dir itself or a scene root containing ``sparse/0``.
    """
    root = Path(colmap_path)
    for candidate in (root, root / "sparse" / "0", root / "sparse"):
        if (candidate / "cameras.bin").exists() or (
            candidate / "cameras.txt"
        ).exists():
            root = candidate
            break
    if (root / "cameras.bin").exists():
        cameras = _read_binary_cameras(root / "cameras.bin")
        images = _read_binary_images(root / "images.bin")
        if (root / "points3D.bin").exists():
            xyz, rgb = _read_binary_points(root / "points3D.bin")
        else:
            xyz = np.zeros((0, 3), np.float32)
            rgb = np.zeros((0, 3), np.float32)
    elif (root / "cameras.txt").exists():
        cameras = _read_text_cameras(root / "cameras.txt")
        images = _read_text_images(root / "images.txt")
        if (root / "points3D.txt").exists():
            xyz, rgb = _read_text_points(root / "points3D.txt")
        else:
            xyz = np.zeros((0, 3), np.float32)
            rgb = np.zeros((0, 3), np.float32)
    else:
        raise FileNotFoundError(f"no COLMAP model found under {colmap_path}")
    return Reconstruction(cameras, images, xyz, rgb)


def get_nerf_norm(reconstruction: Reconstruction) -> dict:
    """Scene normalization (Inria getNerfppNorm): centroid of camera centers,
    radius = 1.1 * max distance. Spec: reference ``utils/colmap.py:5-23``."""
    centers = np.stack(
        [img.camera_center() for img in reconstruction.images.values()]
    )
    center = centers.mean(axis=0, keepdims=True)
    max_dist = np.linalg.norm(centers - center, axis=1).max()
    return {"translate": -center, "radius": float(max_dist * 1.1)}


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation -> wxyz quaternion (COLMAP convention)."""
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1], R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return q * np.sign(q[0]) if q[0] != 0 else q


def write_reconstruction(root, cameras: dict, images: dict,
                         points_xyz=None, points_rgb=None, error: float = 0.0) -> None:
    """Write a binary COLMAP model: cameras {id: (w, h, fx, fy, cx, cy)}
    (PINHOLE), images {id: (qvec wxyz, tvec, camera_id, name)} and an
    optional point cloud (N, 3) with colours in [0, 1], each point with the
    reprojection ``error`` given and an empty track."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cid, (w, h, fx, fy, cx, cy) in cameras.items():
            f.write(struct.pack("<iiQQ", cid, _NAME_TO_ID["PINHOLE"], w, h))
            f.write(struct.pack("<4d", fx, fy, cx, cy))
    with open(root / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for iid, (qvec, tvec, cid, name) in images.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *np.asarray(qvec, np.float64)))
            f.write(struct.pack("<3d", *np.asarray(tvec, np.float64)))
            f.write(struct.pack("<i", cid))
            f.write(name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points
    if points_xyz is None:
        return
    rgb8 = np.clip(np.asarray(points_rgb) * 255.0, 0, 255).astype(np.uint8)
    with open(root / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points_xyz)))
        for i, (p, c) in enumerate(zip(np.asarray(points_xyz, np.float64), rgb8)):
            f.write(struct.pack("<Q3d3Bd", i, *p, *c, error))
            f.write(struct.pack("<Q", 0))  # empty track
