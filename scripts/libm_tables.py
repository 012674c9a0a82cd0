#!/usr/bin/env python3
"""Write ``cv_tpu_torch/csrc/trig64_tables.cuh`` from the C library's bytes.

glibc's double ``sin``/``cos`` (sysdeps/ieee754/dbl-64/s_sin.c, branred.c)
and ``atan2`` (e_atan2.c) read three tables from ``libm.so.6``'s
``.rodata``: ``__sincostab`` (sin, its low part, cos and its low part at
i / 128, i = 0..109), ``toverp`` (2 / pi in 24-bit pieces, branred's
reduction of huge arguments) and ``cij`` (atan2's 241 rows of a point,
atan and five Taylor terms).  This script copies them bit for bit: it reads
each table at its address in glibc 2.36-9+deb12u13's x86-64 ``libm.so.6``
(Debian 12), checks a few of its known values, and writes them as C arrays
of IEEE bits.  ``ops/trig.py`` reads the same header for the plain
versions, and ``tests/test_torch_trig64.py`` finds each table's bytes in
the C library it runs against.

Usage: python3 scripts/libm_tables.py [--libm PATH]  (default: the C library this process loads)
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import os
import struct

# name: (address in .rodata, doubles, (index, value) checks)
TABLES = {
    "kSinCosTab": (0xA9D40, 440, ((0, 0.0), (2, 1.0), (4, 0.0078124205273828315))),
    "kToverp": (0xA9A60, 75, ((0, 10680707.0), (1, 7228996.0))),
    "kAtanCij": (0xB5DC0, 241 * 7, ((0, 0.06347694384761945), (1, 0.063391893014217))),
}
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "cv_tpu_torch", "csrc", "trig64_tables.cuh")


def loaded_libm() -> str:
    """The file of the C math library this process loads (Linux)."""
    ctypes.CDLL(ctypes.util.find_library("m"))
    with open("/proc/self/maps") as maps:
        for line in maps:
            if "libm.so" in line or "libm-" in line:
                return line.split()[-1]
    raise SystemExit("libm_tables: the C math library is not mapped")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--libm", default=None, help="the libm.so.6 to read (default: the one this process loads)")
    args = parser.parse_args()
    data = open(args.libm or loaded_libm(), "rb").read()
    lines = [
        "// glibc 2.36's double sin/cos and atan2 tables, copied bit for bit from",
        "// libm.so.6's .rodata by scripts/libm_tables.py (do not edit by hand).",
        "// trig.cuh reads them on the card, ops/trig.py for the plain versions.",
        "",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace cv_trig {",
        "",
    ]
    for name, (addr, n, checks) in TABLES.items():
        raw = data[addr:addr + 8 * n]
        vals = struct.unpack(f"<{n}d", raw)
        for i, want in checks:
            if vals[i] != want:
                raise SystemExit(f"{name}[{i}] = {vals[i]!r}, expected {want!r}: not glibc 2.36's libm")
        words = struct.unpack(f"<{n}Q", raw)
        lines.append(f"__device__ const uint64_t {name}[{n}] = {{")
        for j in range(0, n, 4):
            lines.append("    " + " ".join(f"0x{w:016x}ull," for w in words[j:j + 4]))
        lines += ["};", ""]
    lines.append("}  // namespace cv_trig")
    with open(OUT, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {os.path.normpath(OUT)}")


if __name__ == "__main__":
    main()
