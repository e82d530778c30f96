"""Read the CIELab -> sRGB grid out of Pillow's LittleCMS, or check
``utils/lab.py`` against Pillow on every 8-bit Lab triple.

    python tools/lab_clut.py            # write wgpu_path_tracing_tpu_torch/utils/lab_clut.npz
    python tools/lab_clut.py --check    # the port's lab_to_rgb against Pillow, 2^24 inputs

Pillow converts "LAB" with a LittleCMS transform from its built-in Lab
profile to its built-in sRGB profile (``Image.convert`` through
``ImageCms.buildTransform``). The tool builds the same transform through
ctypes on the LittleCMS library Pillow ships, checks that it gives
Pillow's pixels, and reads the optimized pipeline's one stage, a 33-point
grid of 16-bit samples (the pipeline is the transform's field after its
formatters and 1-pixel cache, as ``lcms2_internal.h`` lays it out). Needs
Pillow; the port reads only the written file.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wgpu_path_tracing_tpu_torch.utils import lab as LAB  # noqa: E402

# LittleCMS pixel formats: colour space << 16, extra << 7, channels << 3,
# bytes.
PT_RGB, PT_LABV2 = 4, 30
LAB_8X = PT_LABV2 << 16 | 1 << 7 | 3 << 3 | 1  # Pillow's "LAB"
RGBA_8 = PT_RGB << 16 | 1 << 7 | 3 << 3 | 1
LUT_OFFSET = 112  # _cmsTRANSFORM: two formats, five function pointers, cache


def lcms():
    from PIL import Image

    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        Image.__file__)), "pillow.libs", "liblcms2*.so*"))
    lib = ctypes.CDLL(libs[0])
    vp = ctypes.c_void_p
    for fn, res, args in (
            ("cmsCreateLab2Profile", vp, [vp]), ("cmsCreate_sRGBProfile", vp, []),
            ("cmsCreateTransform", vp, [vp, ctypes.c_uint32, vp,
                                        ctypes.c_uint32, ctypes.c_uint32,
                                        ctypes.c_uint32]),
            ("cmsDoTransform", None, [vp, vp, vp, ctypes.c_uint32]),
            ("cmsPipelineStageCount", ctypes.c_uint32, [vp]),
            ("cmsPipelineGetPtrToFirstStage", vp, [vp]),
            ("cmsStageType", ctypes.c_uint32, [vp]),
            ("cmsStageData", vp, [vp])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    return lib


def all_lab() -> np.ndarray:
    v = np.arange(256, dtype=np.uint8)
    lab = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1)
    return lab.reshape(4096, 4096, 3)


def pillow_rgb(lab: np.ndarray) -> np.ndarray:
    from PIL import Image

    im = Image.frombytes("LAB", lab.shape[1::-1], lab.tobytes())
    return np.asarray(im.convert("RGB"))


def read_clut(check: bool = True) -> np.ndarray:
    """The grid of Pillow's LittleCMS transform; with ``check``, first
    hold the transform built here to Pillow's on every Lab triple."""
    lib = lcms()
    t = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), LAB_8X,
                               lib.cmsCreate_sRGBProfile(), RGBA_8, 0, 0)
    if check:
        lab = all_lab().reshape(-1, 3)
        src = np.concatenate([lab, np.zeros((len(lab), 1), np.uint8)], 1)
        src[:, 1:3] ^= 128
        out = np.zeros_like(src)
        lib.cmsDoTransform(t, src.ctypes.data, out.ctypes.data, len(src))
        if not np.array_equal(out[:, :3].reshape(4096, 4096, 3),
                              pillow_rgb(all_lab())):
            raise SystemExit("the ctypes transform is not Pillow's")
    lut = ctypes.c_void_p.from_address(t + LUT_OFFSET).value
    stage = lib.cmsPipelineGetPtrToFirstStage(lut)
    if lib.cmsPipelineStageCount(lut) != 1 or \
            lib.cmsStageType(stage).to_bytes(4, "big") != b"clut":
        raise SystemExit("the optimized pipeline is not one grid")
    table, _, entries = struct.unpack(
        "QQI", ctypes.string_at(lib.cmsStageData(stage), 20))
    if entries != LAB.GRID ** 3 * 3:
        raise SystemExit(f"a grid of {entries} samples")
    return np.frombuffer(ctypes.string_at(table, 2 * entries),
                         np.uint16).reshape((LAB.GRID,) * 3 + (3,)).copy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    if args.check:
        lab = all_lab()
        got, want = LAB.lab_to_rgb(lab), pillow_rgb(lab)
        bad = int((got != want).any(-1).sum())
        print(f"{bad} of {lab.shape[0] * lab.shape[1]} Lab triples differ "
              "from Pillow's")
        return 1 if bad else 0
    np.savez_compressed(LAB.CLUT_PATH, clut=read_clut())
    print(f"wrote {LAB.CLUT_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
