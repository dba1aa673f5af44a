"""COLMAP conversion entry point (reference `convert.py:18-124`;
counterpart of ``event3dgs_tpu/cli/convert.py``, the same command lines).

Runs the external `colmap` binary: feature extraction → exhaustive matching
→ mapper → image undistortion, producing the `sparse/0` layout the scene
loader expects; optional downscaled image copies.

    python -m event3dgs_tpu_torch.cli.convert -s <dir> [--no_gpu] [--resize]
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: list[str]):
    print("+", " ".join(cmd))
    res = subprocess.run(cmd)
    if res.returncode != 0:
        raise SystemExit(f"command failed ({res.returncode}): {cmd[0]}")


def main(argv=None):
    p = argparse.ArgumentParser(description="Run COLMAP on an image folder")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--resize", action="store_true")
    args = p.parse_args(argv)

    colmap = args.colmap_executable
    if shutil.which(colmap) is None:
        print(f"error: '{colmap}' not found on PATH — install COLMAP or pass "
              "--colmap_executable", file=sys.stderr)
        return 1
    use_gpu = "0" if args.no_gpu else "1"
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted", "sparse"), exist_ok=True)
        run([colmap, "feature_extractor",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--ImageReader.single_camera", "1",
             "--ImageReader.camera_model", args.camera,
             "--SiftExtraction.use_gpu", use_gpu])
        run([colmap, "exhaustive_matcher",
             "--database_path", f"{src}/distorted/database.db",
             "--SiftMatching.use_gpu", use_gpu])
        run([colmap, "mapper",
             "--database_path", f"{src}/distorted/database.db",
             "--image_path", f"{src}/input",
             "--output_path", f"{src}/distorted/sparse",
             "--Mapper.ba_global_function_tolerance=0.000001"])

    run([colmap, "image_undistorter",
         "--image_path", f"{src}/input",
         "--input_path", f"{src}/distorted/sparse/0",
         "--output_path", src, "--output_type", "COLMAP"])

    # move sparse files into sparse/0 (reference `convert.py:74-82`)
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        from PIL import Image

        for scale, name in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
            out = os.path.join(src, name)
            os.makedirs(out, exist_ok=True)
            for f in os.listdir(os.path.join(src, "images")):
                with Image.open(os.path.join(src, "images", f)) as im:
                    im.resize((im.width // scale, im.height // scale)).save(
                        os.path.join(out, f)
                    )
    print("Done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
