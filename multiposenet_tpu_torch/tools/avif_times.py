"""Host-clock times of the port's AVIF reader on committed fixtures: for
each file, the median over `--rounds` of `image_io.decode_image` (the
container, the headers, the C library `csrc/av1.c` and libavif's YUV to
RGB) and of `avif.decode_planes_c` (the tiles and filters alone), in
milliseconds and microseconds a pixel, after one warm-up decode; a file
the package refuses is listed with its refusal.

    python -m multiposenet_tpu_torch.tools.avif_times [--rounds 20] \\
        [FILE ...]

prints one JSON line (the package's path beside the times). Without
files it times the 8-bit 480x640 photo and the 10- and 12-bit crops of
tests/fixtures/images. It imports `multiposenet_tpu_torch` from wherever
Python finds it, so running this file by its path with another
checkout's root first on PYTHONPATH times that checkout's reader, in
its own process (an older commit against this one on the same machine).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

FIXTURES = Path(__file__).resolve().parents[2] / "tests" / "fixtures" / \
    "images"
DEFAULT = ("avif_photo_480x640.avif", "avif_10bit_96x128.avif",
           "avif_12bit_64x80.avif")


def median_ms(fn, rounds: int) -> float:
    fn()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def times(paths: list[Path], rounds: int) -> dict:
    import multiposenet_tpu_torch
    from multiposenet_tpu_torch.utils import avif, image_io

    t0 = time.perf_counter()
    avif.library()
    out = {"package": str(Path(multiposenet_tpu_torch.__file__).parent),
           "build_s": time.perf_counter() - t0, "rounds": rounds,
           "files": {}}
    for path in paths:
        data = path.read_bytes()
        try:
            frame = avif.read_image(data).frame
            pixels = frame.header.width * frame.header.height
            decode = median_ms(lambda: image_io.decode_image(data), rounds)
            tiles = median_ms(lambda: avif.decode_planes_c(frame), rounds)
        except ValueError as exc:
            out["files"][path.name] = {"refused": str(exc)}
            continue
        out["files"][path.name] = {
            "bit_depth": frame.seq.bit_depth, "pixels": pixels,
            "decode_ms": decode, "tiles_and_filters_ms": tiles,
            "decode_us_per_pixel": 1e3 * decode / pixels}
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=20)
    args = ap.parse_args(argv)
    paths = args.files or [FIXTURES / n for n in DEFAULT]
    print(json.dumps(times(paths, args.rounds)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
