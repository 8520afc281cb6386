"""Dataset classes: US3D, WHU, SceneFlow, KITTI-2015, Cityscapes (a copy of
``semstereo_tpu/data/datasets.py``, which is numpy and PIL only).

Every dataset returns a dict of numpy arrays with channels-last images from
``get(index, rng)``, its random draws from ``rng``; train samples always
carry ``disparity`` and ``disparity_4`` (the /4 nearest-downsampled ground
truth the loss pyramid reads).  Eval samples carry the host metadata
``top_pad``, ``right_pad`` and ``left_filename`` where the dataset has them.

Registry keys are the original torch code's (``sceneflow``, ``kitti``,
``us3d``, ``cityscapes``, ``WhuDataset``), plus ``whu``, its WHU command
line's default.
"""

from __future__ import annotations

import os

import numpy as np

from semstereo_tpu_torch.data import io, transforms as T

# Cityscapes/KITTI 34-id -> 19-class training-id map
# (reference kitti_dataset_15.py:42-61), ignore = 19.
_IGNORE19 = 19
_KITTI_CLASS_MAP = {
    -1: _IGNORE19, 0: _IGNORE19, 1: _IGNORE19, 2: _IGNORE19, 3: _IGNORE19,
    4: _IGNORE19, 5: _IGNORE19, 6: _IGNORE19, 7: 0, 8: 1, 9: _IGNORE19,
    10: _IGNORE19, 11: 2, 12: 3, 13: 4, 14: _IGNORE19, 15: _IGNORE19,
    16: _IGNORE19, 17: 5, 18: _IGNORE19, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10,
    24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 29: _IGNORE19, 30: _IGNORE19,
    31: 16, 32: 17, 33: 18,
}


def map_kitti_labels(data: np.ndarray) -> np.ndarray:
    lut = np.full(256, _IGNORE19, np.int64)
    for k, v in _KITTI_CLASS_MAP.items():
        if k >= 0:
            lut[k] = v
    return lut[data.astype(np.int64)]


class StereoDataset:
    """Base: list-file driven left/right/disparity(/label) sample source."""

    columns = 3

    def __init__(self, datapath: str, list_filename: str, training: bool):
        self.datapath = datapath
        self.training = training
        lines = [line.split() for line in io.read_all_lines(list_filename)]
        if not all(len(l) >= self.columns for l in lines):
            raise ValueError(f"{list_filename}: expected {self.columns} columns")
        self.rows = lines

    def __len__(self):
        return len(self.rows)

    def _path(self, rel: str) -> str:
        return os.path.join(self.datapath, rel)

    def __getitem__(self, index):
        return self.get(index, np.random.default_rng())

    def get(self, index: int, rng: np.random.Generator) -> dict:
        raise NotImplementedError


class Us3dDataset(StereoDataset):
    """US3D remote-sensing tiles: 4-column lists (left, right, disp TIF,
    label TIF); full 1024x1024 tiles, no crop, no photometric aug
    (reference us3d_.py:38-215)."""

    columns = 4

    def __init__(self, datapath, list_filename, training, with_gradients=False):
        super().__init__(datapath, list_filename, training)
        self.with_gradients = with_gradients

    def get(self, index, rng):
        l, r, d, lab = self.rows[index][:4]
        left_raw = io.load_image_rgb(self._path(l))
        right_raw = io.load_image_rgb(self._path(r))
        disparity = io.load_disp_float(self._path(d))
        label = io.load_label(self._path(lab))

        sample = {
            "left": io.normalize_image(left_raw),
            "right": io.normalize_image(right_raw),
            "disparity": disparity,
            "label": label,
        }
        if self.training:
            pyr = T.gt_pyramid(disparity, (4, 8, 16))
            sample.update(
                disparity_4=pyr[4], disparity_8=pyr[8], disparity_16=pyr[16],
                label_2=np.ascontiguousarray(label[::2, ::2]),
                label_4=np.ascontiguousarray(label[::4, ::4]),
            )
        else:
            sample.update(top_pad=0, right_pad=0, left_filename=l)
        if self.with_gradients:
            gx, gy = io.image_gradients(left_raw)
            sample.update(gx=gx, gy=gy)
        return sample


class WhuDataset(StereoDataset):
    """WHU aerial stereo: 3-column lists, disparity = PNG/256, no labels
    (reference whu_dataset.py:16-92)."""

    columns = 3

    def get(self, index, rng):
        l, r, d = self.rows[index][:3]
        sample = {
            "left": io.normalize_image(io.load_image_rgb(self._path(l))),
            "right": io.normalize_image(io.load_image_rgb(self._path(r))),
            "disparity": io.load_disp_png256(self._path(d)),
        }
        if self.training:
            pyr = T.gt_pyramid(sample["disparity"], (4, 8, 16))
            sample.update(
                disparity_4=pyr[4], disparity_8=pyr[8], disparity_16=pyr[16]
            )
        else:
            sample.update(top_pad=0, right_pad=0, left_filename=l)
        return sample


class SceneFlowDataset(StereoDataset):
    """SceneFlow: PFM disparities; train = asymmetric photometric jitter +
    random 256x512 crop + random right-image occlusion; eval = fixed 960x512
    bottom-right crop (reference sceneflow_dataset_augmentation.py)."""

    columns = 3

    def __init__(self, datapath, list_filename, training, crop_size=(256, 512)):
        super().__init__(datapath, list_filename, training)
        self.crop_size = crop_size

    def get(self, index, rng):
        l, r, d = self.rows[index][:3]
        left = io.load_image_rgb(self._path(l))
        right = io.load_image_rgb(self._path(r))
        disparity, _ = io.pfm_imread(self._path(d))
        disparity = np.ascontiguousarray(disparity, np.float32)

        if self.training:
            left = T.photometric_jitter(left, rng)
            right = T.photometric_jitter(right, rng)
            left, right, disparity = T.random_crop(
                [left, right, disparity], self.crop_size, rng
            )
            right = T.random_occlusion(right, rng)
            return {
                "left": io.normalize_image(left),
                "right": io.normalize_image(right),
                "disparity": disparity,
                "disparity_4": np.ascontiguousarray(disparity[::4, ::4]),
            }
        h, w = left.shape[:2]
        ch, cw = 512, 960
        left, right = left[h - ch :, w - cw :], right[h - ch :, w - cw :]
        disparity = disparity[h - ch :, w - cw :]
        return {
            "left": io.normalize_image(left),
            "right": io.normalize_image(right),
            "disparity": disparity,
            "top_pad": 0,
            "right_pad": 0,
        }


class KittiDataset(StereoDataset):
    """KITTI 2015: disp PNG/256, semantic labels from the sibling semantic/
    dir (34->19 map); train = 512x256 crop biased to the lower image; eval =
    zero-pad to 1248x384 (reference kitti_dataset_15.py)."""

    columns = 2

    def __init__(self, datapath, list_filename, training, crop_size=(256, 512)):
        super().__init__(datapath, list_filename, training)
        self.has_gt = len(self.rows[0]) >= 3
        self.crop_size = tuple(crop_size)  # (H, W)

    def _label_path(self, disp_rel: str) -> str:
        parts = disp_rel.split("/")
        return self._path(parts[0] + "/semantic/" + parts[-1])

    def get(self, index, rng):
        row = self.rows[index]
        left = io.load_image_rgb(self._path(row[0]))
        right = io.load_image_rgb(self._path(row[1]))
        disparity = label = None
        if self.has_gt:
            disparity = io.load_disp_png256(self._path(row[2]))
            label = map_kitti_labels(io.load_label(self._label_path(row[2]))).astype(
                np.float32
            )

        if self.training:
            h, w = left.shape[:2]
            ch, cw = self.crop_size
            x1 = int(rng.integers(0, w - cw + 1))
            if int(rng.integers(0, 11)) >= 8:
                y1 = int(rng.integers(0, h - ch + 1))
            else:
                y1 = int(rng.integers(int(0.3 * h), h - ch + 1))
            left = left[y1 : y1 + ch, x1 : x1 + cw]
            right = right[y1 : y1 + ch, x1 : x1 + cw]
            disparity = disparity[y1 : y1 + ch, x1 : x1 + cw]
            label = label[y1 : y1 + ch, x1 : x1 + cw]
            return {
                "left": io.normalize_image(left),
                "right": io.normalize_image(right),
                "disparity": disparity,
                "disparity_4": np.ascontiguousarray(disparity[::4, ::4]),
                "label": label,
            }

        h, w = left.shape[:2]
        top_pad, right_pad = 384 - h, 1248 - w
        if top_pad < 0 or right_pad < 0:
            raise ValueError(f"{row[0]}: {h}x{w} is larger than the 384x1248 eval pad")
        pad_img = lambda im: np.pad(im, ((top_pad, 0), (0, right_pad), (0, 0)))
        sample = {
            "left": io.normalize_image(pad_img(left)),
            "right": io.normalize_image(pad_img(right)),
            "top_pad": top_pad,
            "right_pad": right_pad,
            "left_filename": row[0],
        }
        if self.has_gt:
            # disparity pads with 0 = the KITTI no-gt sentinel, so the
            # 'positive' mask policy excludes padded borders from loss and
            # metrics; labels pad with the ignore id so the confusion matrix
            # (built over num_classes-1 real classes) skips them too.
            sample["disparity"] = np.pad(disparity, ((top_pad, 0), (0, right_pad)))
            sample["label"] = np.pad(
                label, ((top_pad, 0), (0, right_pad)),
                constant_values=float(_IGNORE19),
            )
        return sample


class CityscapesDataset(KittiDataset):
    """Cityscapes stereo: KITTI pipeline + RandomVdisp right-image
    perturbation and label columns in the list file
    (reference cityscapes_dataset_c.py)."""

    def _label_path(self, disp_rel: str) -> str:  # labels are column 4
        raise NotImplementedError

    def get(self, index, rng):
        row = self.rows[index]
        left = io.load_image_rgb(self._path(row[0]))
        right = io.load_image_rgb(self._path(row[1]))
        disparity = label = None
        if len(row) >= 4:
            disparity = io.load_disp_png256(self._path(row[2]))
            label = map_kitti_labels(io.load_label(self._path(row[3]))).astype(np.float32)

        if self.training:
            left = T.photometric_jitter(left, rng)
            right = T.photometric_jitter(right, rng)
            if rng.binomial(1, 0.5):
                right = T.random_vdisp(right, angle=0.05, px=1.0, rng=rng)
            left, right, disparity, label = T.random_crop(
                [left, right, disparity, label], self.crop_size, rng
            )
            # Cityscapes occludes with p=0.2, not SceneFlow's 0.5
            # (reference cityscapes_dataset_c.py:121)
            right = T.random_occlusion(right, rng, p=0.2)
            return {
                "left": io.normalize_image(left),
                "right": io.normalize_image(right),
                "disparity": np.ascontiguousarray(disparity, np.float32),
                "disparity_4": np.ascontiguousarray(disparity[::4, ::4], np.float32),
                "label": label,
            }

        sample = {
            "left": io.normalize_image(left),
            "right": io.normalize_image(right),
        }
        if disparity is not None:
            sample.update(disparity=disparity, label=label)
        return sample


__datasets__ = {
    "sceneflow": SceneFlowDataset,
    "kitti": KittiDataset,
    "us3d": Us3dDataset,
    "cityscapes": CityscapesDataset,
    "WhuDataset": WhuDataset,
    "whu": WhuDataset,
}
