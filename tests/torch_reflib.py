"""The JAX package's host library, built for the port's tests without
the build race of `transferia_tpu.native.lib()`.

`lib()` compiles in place in the package directory and, when a load
fails, keeps None for the life of the process.  Under parallel test
workers one worker can load while another's compiler is writing the
file, and then it has no library for good.  `build_reference_library`
compiles the package's own sources into a directory of the caller's
under a temporary name, renames the file into place and binds it as
`lib()` binds it.
"""

import ctypes
import os
import shutil
import subprocess

from transferia_tpu import native as ref_native


def build_reference_library(out_dir):
    cxx = shutil.which("g++") or shutil.which("clang++")
    assert cxx is not None, "the JAX package's host library needs g++"
    srcs = [ref_native._DIR / "hostops.cpp", ref_native._DIR / "parquetdec.cpp"]
    tmp = out_dir / f"libhostops.{os.getpid()}.tmp.so"
    subprocess.run([cxx, "-O3", "-shared", "-fPIC", "-o", str(tmp)]
                   + [str(s) for s in srcs] + ["-ldl"],
                   check=True, capture_output=True, timeout=300)
    final = out_dir / "libhostops.so"
    os.replace(tmp, final)
    return ref_native._ProfiledLib(ref_native._bind(ctypes.CDLL(str(final))))
