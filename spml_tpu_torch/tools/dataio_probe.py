"""Can this host build native/dataio (the JAX package's fused C++ train
item)?

The library links libjpeg, libpng and zlib (native/dataio/Makefile), so
g++ needs their headers and the linker their libraries. Prints, one line
each: which of jpeglib.h, png.h and zlib.h g++ can include; the libjpeg
and libpng entries of `ldconfig -p`; the libraries Pillow's wheel carries
for itself (pillow.libs/). Exits 1 when a header is missing.

    python -m spml_tpu_torch.tools.dataio_probe
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HEADERS = ("jpeglib.h", "png.h", "zlib.h")


def missing_headers(headers=HEADERS) -> list[str]:
    """The headers of `headers` that g++ cannot include (all of them when
    there is no g++)."""
    gxx = shutil.which("g++")
    if gxx is None:
        return list(headers)
    return [h for h in headers if subprocess.run(
        [gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
        input=f"#include <{h}>\n", capture_output=True,
        text=True).returncode != 0]


def main() -> int:
    missing = missing_headers()
    print(f"g++ {shutil.which('g++')}; headers {', '.join(HEADERS)}; "
          f"missing: {', '.join(missing) or 'none'}", flush=True)
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True,
                              text=True).stdout
    found = sorted({ln.split()[0] for ln in ldconfig.splitlines()
                    if "libjpeg" in ln or "libpng" in ln})
    print(f"ldconfig: {' '.join(found) or 'no libjpeg or libpng'}",
          flush=True)
    import PIL
    bundled = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                           "pillow.libs")
    libs = sorted(os.listdir(bundled)) if os.path.isdir(bundled) else []
    print(f"Pillow {PIL.__version__} carries: {' '.join(libs) or 'nothing'}",
          flush=True)
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main())
