"""KITTI-format file IO: label txt parser/writer, velodyne bins, PNG images.

Own copy of dfu3d_tpu/data/kitti_io.py. Format parity with the reference
(pcdet/utils/object3d_kitti.py and kitti_dataset.py:339-419's prediction
writer): these files are the interchange contract with the reference
ecosystem (pseudo-labels, predictions, gt). PNGs are read with zlib and
numpy, so no imaging library is needed: image shapes come from the header,
pixels from `read_png`, whose row unfilter is native C++
(data/csrc/png_unfilter.cpp, built with g++ at first use) with a numpy twin.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from .. import gxx_build


def cls_type_to_id(cls_type: str, classes=("Car", "Pedestrian", "Cyclist", "Van")) -> int:
    if cls_type not in classes:
        return -1
    return classes.index(cls_type) + 1


class Object3d:
    """One KITTI label line (reference: object3d_kitti.Object3d)."""

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.truncation = float(label[1])
        self.occlusion = float(label[2])  # 0..3 (3 = unknown)
        self.alpha = float(label[3])
        self.box2d = np.array(
            (float(label[4]), float(label[5]), float(label[6]), float(label[7])),
            dtype=np.float32,
        )
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])
        self.loc = np.array(
            (float(label[11]), float(label[12]), float(label[13])), dtype=np.float32
        )
        self.dis_to_cam = np.linalg.norm(self.loc)
        self.ry = float(label[14])
        self.score = float(label[15]) if len(label) == 16 else -1.0
        self.level_str = None
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self) -> int:
        """KITTI difficulty from 2D height / occlusion / truncation."""
        height = float(self.box2d[3]) - float(self.box2d[1]) + 1
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            self.level_str = "Easy"
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            self.level_str = "Moderate"
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            self.level_str = "Hard"
            return 2
        self.level_str = "UnKnown"
        return -1


def get_objects_from_label(label_file) -> list:
    with open(label_file, "r") as f:
        lines = [ln for ln in f.readlines() if ln.strip()]
    return [Object3d(line) for line in lines]


def read_velodyne_bin(path, num_features: int = 4) -> np.ndarray:
    return np.fromfile(str(path), dtype=np.float32).reshape(-1, num_features)


def read_velodyne_depth_npy(path) -> np.ndarray:
    """Fused/densified cloud written by the pseudo-box factory: (N, 8) fp16."""
    return np.load(str(path)).astype(np.float32)


PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def get_image_shape(img_path) -> np.ndarray:
    """[h, w] of a PNG, read from its IHDR chunk: the signature (8 bytes),
    the chunk's length and type (8), then width and height as big-endian
    uint32 at bytes 16-23."""
    with open(img_path, "rb") as f:
        head = f.read(24)
    if len(head) < 24 or head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{img_path} is not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return np.array([h, w], dtype=np.int32)


def format_kitti_label_line(name, alpha, bbox, dims_lhw, loc, ry, score=None) -> str:
    """One KITTI label/prediction line. dims printed as h, w, l (KITTI order);
    truncated/occluded fixed at -1 for predictions (kitti_dataset.py:404-417)."""
    l, h, w = dims_lhw
    parts = [
        name, "-1", "-1", f"{alpha:.4f}",
        f"{bbox[0]:.4f}", f"{bbox[1]:.4f}", f"{bbox[2]:.4f}", f"{bbox[3]:.4f}",
        f"{h:.4f}", f"{w:.4f}", f"{l:.4f}",
        f"{loc[0]:.4f}", f"{loc[1]:.4f}", f"{loc[2]:.4f}", f"{ry:.4f}",
    ]
    if score is not None:
        parts.append(f"{score:.4f}")
    return " ".join(parts)


def write_kitti_label_file(path, annos_dict):
    """Write a frame's predictions in KITTI format (same column layout as the
    reference's generate_prediction_dicts --save_to_file path)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    n = len(annos_dict["name"])
    for k in range(n):
        lines.append(
            format_kitti_label_line(
                annos_dict["name"][k],
                annos_dict["alpha"][k],
                annos_dict["bbox"][k],
                annos_dict["dimensions"][k],
                annos_dict["location"][k],
                annos_dict["rotation_y"][k],
                annos_dict["score"][k] if "score" in annos_dict else None,
            )
        )
    path.write_text("\n".join(lines) + ("\n" if lines else ""))


# --- PNG pixels -------------------------------------------------------------

PNG_UNFILTER_SOURCE = Path(__file__).resolve().parent / "csrc" / "png_unfilter.cpp"
PNG_BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc_build"
# 8-bit colour types read_png takes: gray, RGB, RGBA -> bytes per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}
_U8 = ctypes.POINTER(ctypes.c_uint8)
_PNG_SIGNATURES = {
    "png_unfilter": (ctypes.c_int64, [_U8, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _U8]),
}


def png_unfilter_lib():
    """The native unfilter, built if needed and loaded once per process; raises
    if it cannot be built or loaded."""
    return gxx_build.load(PNG_UNFILTER_SOURCE, PNG_BUILD_DIR, "libpng_unfilter",
                          "the native PNG unfilter", _PNG_SIGNATURES)


def _unfilter_native(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    out = np.empty(height * row_bytes, np.uint8)
    bad = png_unfilter_lib().png_unfilter(raw.ctypes.data_as(_U8), height, row_bytes, bpp,
                                          out.ctypes.data_as(_U8))
    if bad >= 0:
        raise ValueError(f"PNG row {bad} has filter type {raw[bad * (row_bytes + 1)]}, not 0-4")
    return out.reshape(height, row_bytes)


def _unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """The numpy twin of the native unfilter (PNG specification section 9):
    None, Sub and Up are vectorised along the row; Average and Paeth read the
    reconstructed byte to the left, so they loop over the row's pixels."""
    rows = raw.reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int32)
    for r in range(height):
        kind, src = rows[r, 0], rows[r, 1:].astype(np.int32)
        if kind == 0:
            cur = src
        elif kind == 1:
            cur = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (src + prev) & 0xFF
        elif kind in (3, 4):
            cur = np.zeros(row_bytes, np.int32)
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for i in range(0, row_bytes, bpp):
                up = prev[i:i + bpp]
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    p = left + up - up_left
                    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
                    pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
                left = (src[i:i + bpp] + pred) & 0xFF
                cur[i:i + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG row {r} has filter type {kind}, not 0-4")
        out[r] = cur
        prev = cur.astype(np.int32)
    return out


def read_png(path, use_native: bool = True) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit, non-interlaced gray, RGB or RGBA PNG, as
    PIL's `Image.open(path).convert("RGB")` gives it: gray is repeated over
    the three channels, alpha is dropped. Any other PNG raises. The rows are
    unfiltered natively; `use_native=False` takes the numpy twin."""
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path} has no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or compression or filtering or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray, RGB or RGBA PNGs are read "
                         f"(bit depth {depth}, colour type {colour}, interlace {interlace})")
    bpp = _PNG_CHANNELS[colour]
    row_bytes = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (row_bytes + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{height * (row_bytes + 1)}")
    unfilter = _unfilter_native if use_native else _unfilter_plain
    pixels = unfilter(raw, height, row_bytes, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])
