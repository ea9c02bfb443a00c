"""View dataset over a COLMAP reconstruction.

Counterpart (numpy) of ``gaussian_splatting_lightning_tpu/data/dataset.py``
(``ViewItem``, ``ColmapDataset``, ``ViewSampler``). Images are read with
OpenCV (``data/image_io.py``).
Behavioral spec: reference ``ColmapDataset`` / ``ColmapDataModule``
(``gs_lightning/datasets/colmap_dataset.py``): per-view dict of {image,
tanfovx/y, background, viewmatrix, projmatrix, campos}, resize_to/downscale,
optional mask multiply, white/black background, full in-RAM preload, and
index-file train/valid splits. Host-side numpy; the training loop stacks views
into device batches (the reference is pinned to batch=1 — we batch).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Optional, Sequence, Union

import cv2
import numpy as np

from gaussian_splatting_lightning_tpu_torch.core.camera import get_projection_matrix
from gaussian_splatting_lightning_tpu_torch.data import colmap as colmap_io
from gaussian_splatting_lightning_tpu_torch.data.image_io import read_image


@dataclasses.dataclass
class ViewItem:
    """One view, host-side (numpy). Arrays are float32."""

    image: np.ndarray  # (3, H, W) in [0, 1]
    viewmatrix: np.ndarray  # (4, 4) row-vector
    projmatrix: np.ndarray  # (4, 4) full = view @ proj^T
    campos: np.ndarray  # (3,)
    tanfovx: float
    tanfovy: float
    background: np.ndarray  # (3,)
    name: str = ""
    depth: Optional[np.ndarray] = None  # (1, H, W) inverse depth, for the
    # optional depth-regularization loss (TrainConfig.w_depth)


def _load_image(path: Path) -> np.ndarray:
    img = read_image(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return np.asarray(img)[..., :3]


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    if img.shape[1] == w and img.shape[0] == h:
        return img
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)


class ColmapDataset:
    """Spec: reference ``ColmapDataset`` (colmap_dataset.py:24-145)."""

    def __init__(
        self,
        colmap_path: str,
        image_folder: str,
        image_idx: Optional[Union[Sequence[int], str]] = None,
        mask_folder: Optional[str] = None,
        depth_folder: Optional[str] = None,
        resize_to: Optional[int] = None,
        downscale: Optional[float] = None,
        white_background: bool = False,
        z_near: float = 0.01,
        z_far: float = 100.0,
        preload_data: bool = True,
        reconstruction: Optional[colmap_io.Reconstruction] = None,
    ):
        self.image_folder = Path(image_folder)
        self.mask_folder = Path(mask_folder) if mask_folder else None
        self.depth_folder = Path(depth_folder) if depth_folder else None
        self.resize_to = resize_to
        self.downscale = downscale
        self.z_near, self.z_far = z_near, z_far
        self.background = (
            np.ones(3, np.float32) if white_background else np.zeros(3, np.float32)
        )

        self.reconstruction = reconstruction or colmap_io.read_reconstruction(
            colmap_path
        )
        self.image_indices = self._load_image_idx(image_idx)
        if self.image_indices is None:
            self.image_indices = sorted(self.reconstruction.images.keys())
        self._cache = {}
        if preload_data:
            # threaded preload: image decode + resize dominate and release
            # the GIL (cv2), so the reference's serial preload loop
            # (colmap_dataset.py:60-61) parallelizes across cores
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=8) as pool:
                for i, item in enumerate(pool.map(self.build_item, range(len(self)))):
                    self._cache[i] = item

    @staticmethod
    def _load_image_idx(image_idx) -> Optional[List[int]]:
        if image_idx is None:
            return None
        if isinstance(image_idx, (list, tuple, np.ndarray)):
            return [int(i) for i in image_idx]
        arr = np.loadtxt(image_idx, delimiter=",", dtype=np.int64).reshape(-1)
        return [int(i) for i in arr]

    def __len__(self) -> int:
        return len(self.image_indices)

    def __getitem__(self, index: int) -> ViewItem:
        if index not in self._cache:
            self._cache[index] = self.build_item(index)
        return self._cache[index]

    def build_item(self, index: int) -> ViewItem:
        """Spec: colmap_dataset.py:77-109 (matrix chain) and 124-145 (image)."""
        img_info = self.reconstruction.images[self.image_indices[index]]
        cam_info = self.reconstruction.cameras[img_info.camera_id]

        image = self._load_image_to_array(img_info.name)

        world_view = np.eye(4)
        world_view[:, :3] = img_info.cam_from_world().T
        projection = get_projection_matrix(
            cam_info.fx, cam_info.fy, cam_info.width, cam_info.height,
            self.z_near, self.z_far,
        ).T
        full_proj = world_view @ projection
        campos = np.linalg.inv(world_view)[3, :3]

        depth = None
        if self.depth_folder is not None:
            depth = self._load_depth(img_info.name, image.shape[-2:])

        return ViewItem(
            image=image,
            viewmatrix=world_view.astype(np.float32),
            projmatrix=full_proj.astype(np.float32),
            campos=campos.astype(np.float32),
            tanfovx=float((cam_info.width * 0.5) / cam_info.fx),
            tanfovy=float((cam_info.height * 0.5) / cam_info.fy),
            background=self.background,
            name=img_info.name,
            depth=depth,
        )

    def _load_depth(self, image_name: str, hw) -> np.ndarray:
        """(1, H, W) inverse-depth map for the depth-regularization loss:
        `<stem>.npy` (float inverse depth) next to each image in
        depth_folder. Resized to the training resolution."""
        h, w = hw
        path = (self.depth_folder / image_name).with_suffix(".npy")
        depth = np.load(path).astype(np.float32)
        if depth.ndim == 3:
            depth = depth.squeeze()
        depth = _resize(depth, w, h)
        return depth[None].astype(np.float32)

    def _load_image_to_array(self, image_name: str) -> np.ndarray:
        image = _load_image(self.image_folder / image_name)
        h, w = image.shape[:2]
        if self.downscale is not None:
            h, w = int(h * self.downscale), int(w * self.downscale)
        elif self.resize_to is not None:
            scale = self.resize_to / max(h, w)
            h, w = int(h * scale), int(w * scale)
        # neither set: keep native resolution (reference resizes only when
        # configured, colmap_dataset.py:124-135)
        image = _resize(image, w, h).astype(np.float32) / 255.0
        if self.mask_folder is not None:
            mask = _load_image(self.mask_folder / image_name)
            mask = _resize(mask, w, h).astype(np.float32) / 255.0
            image = image * mask
        return np.moveaxis(image, -1, 0).astype(np.float32)


class ViewSampler:
    """Iteration-count-defined random sampling without replacement.

    Spec: reference ``ConfigTrainDataloader`` (datasets/dataloader.py:11-21):
    torch RandomSampler draws repeated fresh permutations of the view set
    until num_iters samples are yielded, reproduced with numpy permutations
    (the JAX package's sequence for the same seed).
    """

    def __init__(self, n_views: int, seed: int = 0):
        self.n_views = n_views
        self.rng = np.random.default_rng(seed)
        self._perm: List[int] = []

    def next_index(self) -> int:
        if not self._perm:
            self._perm = list(self.rng.permutation(self.n_views))
        return int(self._perm.pop(0))

    def next_batch(self, batch_size: int) -> List[int]:
        return [self.next_index() for _ in range(batch_size)]

    def state(self) -> dict:
        """JSON-serializable snapshot for exact-trajectory resume (the
        trainer checkpoints this so a restored run draws the same view
        sequence the original would have)."""
        return {
            "sampler_state": self.rng.bit_generator.state,
            "perm": [int(i) for i in self._perm],
        }

    def set_state(self, state: dict) -> None:
        self.rng = np.random.default_rng()
        self.rng.bit_generator.state = state["sampler_state"]
        self._perm = list(state["perm"])
