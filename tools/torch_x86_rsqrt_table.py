#!/usr/bin/env python3
"""Writes audio_codec_torch/data/x86_rsqrt.npy: the x86 `rsqrtps`
approximation that XLA:CPU starts its reciprocal square root from.

XLA:CPU lowers `rsqrt` (and `a / sqrt(b)`, which its simplifier rewrites
into `a * rsqrt(b)`) to the hardware estimate `vrsqrtps` followed by two
Newton steps with fused multiply-adds. The estimate is exact to 12 bits and
depends only on the exponent's parity and the top 10 bits of the mantissa,
and it scales with the exponent, so 2 x 1024 values made on the machine
that runs the reference reproduce it (`numerics.xla_rsqrt`). The table
holds rsqrtps(x) for x = (1 + m / 1024) * 2^p, p in {0, 1}, m in 0..1023.

Run on an x86 host with a C compiler: python3 tools/torch_x86_rsqrt_table.py
"""
from __future__ import annotations

import subprocess
import tempfile
from pathlib import Path

import numpy as np

OUT = Path(__file__).resolve().parent.parent / "audio_codec_torch" / "data" / "x86_rsqrt.npy"
SRC = r"""
#include <immintrin.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>
int main(void) {
  for (int p = 0; p < 2; ++p)
    for (int m = 0; m < 1024; ++m) {
      uint32_t u = ((uint32_t)(127 + p) << 23) | ((uint32_t)m << 13);
      float x, o[8];
      memcpy(&x, &u, 4);
      _mm256_storeu_ps(o, _mm256_rsqrt_ps(_mm256_set1_ps(x)));
      fwrite(o, 4, 1, stdout);
    }
  return 0;
}
"""


def main():
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "rsqrt.c", Path(tmp) / "rsqrt"
        src.write_text(SRC)
        subprocess.run(["cc", "-O1", "-mavx", "-o", str(exe), str(src)], check=True)
        raw = subprocess.run([str(exe)], check=True, capture_output=True).stdout
    table = np.frombuffer(raw, np.float32)
    assert table.size == 2048
    np.save(OUT, table)
    print(f"wrote {OUT} ({table.size} values)")


if __name__ == "__main__":
    main()
