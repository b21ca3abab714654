"""Build and load the CUDA kernels of srbx_torch.

The sources under `srbx_torch/csrc/` are compiled at first use with `nvcc`,
one process per source, all started together, and linked into one shared
library with a plain C interface, which is loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC
         -Xptxas -v -c csrc/<name>.cu -o build/<hash>/<name>.o   # each source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
         srbx_torch/build/libsrbx_torch_<hash>.so build/<hash>/*.o

The file name carries a hash of the sources and flags, so an edit rebuilds.
`torch.utils.cpp_extension.load` is not used: a source that includes
PyTorch's headers takes minutes to compile, a plain C interface seconds.
There is no CPU fallback here: without `nvcc` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

# No --use_fast_math: the kernels keep IEEE division and square root.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + (
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_QP_FUSED_ARGTYPES = (
    [_P] * 9                                   # P c G h x0 | x z s stat
    + [ctypes.c_longlong, ctypes.c_int]        # B, mi
    + [ctypes.c_double] * 6                    # abstol reltol reg_primal
    #                                            reg_dual sigma_min step_frac
    + [ctypes.c_int] * 3                       # max_iters refine has_x0
    + [_P]                                     # stream
)
_QP_GENERAL_ARGTYPES = (
    [_P] * 12                          # P c A b G h x0 | x y z s stat
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    #                                    B, n, me, mi
    + [ctypes.c_double] * 6            # abstol reltol reg_primal reg_dual
    #                                    sigma_min step_frac
    + [ctypes.c_int] * 3               # max_iters refine has_x0
    + [_P]                             # stream
)
_SPD_SOLVE_ARGTYPES = [_P] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_P]
_SPD_INVERSE_ARGTYPES = [_P] * 2 + [ctypes.c_longlong, ctypes.c_int, _P]
_CHOLESKY_ARGTYPES = [_P] * 2 + [ctypes.c_longlong, ctypes.c_int, _P]
_CHO_SOLVE_ARGTYPES = ([_P] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
                       + [_P])
_RESIDENT_WARPS_ARGTYPES = [ctypes.c_int, ctypes.c_int]   # f64, mi
_RESIDENT_WARPS_GENERAL_ARGTYPES = [ctypes.c_int] * 4     # f64, n, me, mi
_RESIDENT_WARPS_KR_ARGTYPES = [ctypes.c_int] * 3          # f64, k, r
_GEOMETRY_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_longlong, _P])
#                                                           f64 k r B out
ENTRY_POINTS = {
    "srbx_qp_fused_noeq_f32": _QP_FUSED_ARGTYPES,
    "srbx_qp_fused_noeq_f64": _QP_FUSED_ARGTYPES,
    "srbx_qp_fused_noeq_resident_warps": _RESIDENT_WARPS_ARGTYPES,
    "srbx_qp_general_f32": _QP_GENERAL_ARGTYPES,
    "srbx_qp_general_f64": _QP_GENERAL_ARGTYPES,
    "srbx_qp_general_resident_warps": _RESIDENT_WARPS_GENERAL_ARGTYPES,
    "srbx_spd_solve_f32": _SPD_SOLVE_ARGTYPES,
    "srbx_spd_solve_f64": _SPD_SOLVE_ARGTYPES,
    "srbx_spd_inverse_f32": _SPD_INVERSE_ARGTYPES,
    "srbx_spd_inverse_f64": _SPD_INVERSE_ARGTYPES,
    "srbx_spd_resident_warps": _RESIDENT_WARPS_KR_ARGTYPES,
    "srbx_spd_launch_geometry": _GEOMETRY_ARGTYPES,
    "srbx_pallas_cholesky_f32": _CHOLESKY_ARGTYPES,
    "srbx_pallas_cholesky_f64": _CHOLESKY_ARGTYPES,
    "srbx_pallas_cho_solve_f32": _CHO_SOLVE_ARGTYPES,
    "srbx_pallas_cho_solve_f64": _CHO_SOLVE_ARGTYPES,
    "srbx_pallas_resident_warps": _RESIDENT_WARPS_KR_ARGTYPES,
    "srbx_pallas_launch_geometry": _GEOMETRY_ARGTYPES,
}


def find_nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = [
        Path(home) / "bin" / "nvcc"
        for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"))
        if home
    ]
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for cand in candidates:
        if cand.is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, $CUDA_PATH/bin, PATH and "
        f"{DEFAULT_CUDA_HOME}/bin): srbx_torch's CUDA kernels are compiled "
        "with nvcc from the CUDA toolkit at first use, and there is no "
        "fallback for CUDA tensors."
    )


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libsrbx_torch_{digest.hexdigest()[:16]}.so"


def _run_all(commands):
    """Run the commands concurrently; raise with the output of any that
    fails. Returns their combined output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(commands, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile csrc/ into the build directory unless this version exists:
    one nvcc per source, all at once, then one link."""
    lib = library_path()
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    obj_dir = BUILD_DIR / f"{lib.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    objs = [obj_dir / f"{src.stem}.o" for src in sources()]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
                    for src, obj in zip(sources(), objs)])
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    shutil.rmtree(obj_dir, ignore_errors=True)
    # -Xptxas -v reports registers, stack and spills per kernel
    lib.with_suffix(".log").write_text(log)
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's signature."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
