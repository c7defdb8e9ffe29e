"""Builds the CUDA sources under ``csrc/`` and binds them with ``ctypes``.

Every ``*.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and the objects are linked into one shared library
under ``build/`` at the root of the checkout. The library's name carries a
hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. The entries have a plain C interface:
raw pointers, sizes and the CUDA stream; each returns ``cudaGetLastError()``
after its launches, and ``check`` raises on anything but 0.

`launch` is the lean bare launch: the C entry looked up once, the raw
handle of the current stream, and the device made current only where it
is not already.

Nothing here runs at import: the first kernel launch calls ``load_library``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p      # every pointer and the stream
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry -> argtypes. ctypes passes a Python int as a 32-bit int unless
# told otherwise, which cuts a 64-bit pointer: every entry is listed here.
_SIGNATURES = {
    # fcodes acodes fvalid adict bounds nq jcodes jvalid rcount n_shards
    # width corr_a nr_a corr_base corr_j nr_j vbounds out stream
    "scan_exact": (_P, _P, _P, _P, _P, _I, _P, _P, _P, _I, _L, _P, _L, _I,
                   _P, _L, _P, _P, _P),
    # table(host) n_islands bounds nq join corr_a nr_a corr_base corr_j nr_j
    # vbounds(host) out stream
    "scan_exact_islands": (_P, _I, _P, _I, _I, _P, _L, _I, _P, _L, _P, _P,
                           _P),
    # stack nr corr_base vbounds nq out stream
    "scan_values": (_P, _L, _I, _P, _I, _P, _P),
    # join vec corr qn blocks_per_sm (int*)
    "scan_exact_occupancy": (_I, _I, _I, _I, _P),
    # join corr qn blocks_per_sm (int*)
    "scan_islands_occupancy": (_I, _I, _I, _P),
    # queries n_shards width keys vals n_buckets slots default out stream
    "hash_probe": (_P, _I, _L, _P, _P, _I, _I, _I, _P, _P),
    # a ai b bi out_keys out_idx rows wa wb stream
    "merge_runs": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # keys offsets(host) k out_keys out_idx stream
    "merge_runs_kway": (_P, _P, _I, _P, _P, _P),
    # in out scratch rows width width_pad key_type stream
    "bitonic_sort_rows": (_P, _P, _P, _I, _I, _I, _I, _P),
    # a a_stride wa b b_stride wb out out_stride w_out rows key_type stream
    "bitonic_merge_rows": (_P, _L, _I, _P, _L, _I, _P, _L, _I, _I, _I, _P),
    # old w_old vals w_val svals merged w_merge rows scratch stream
    "bitonic_apply": (_P, _I, _P, _I, _P, _P, _I, _I, _P, _P),
    # src prev dirty out n block stream
    "snapshot_copy": (_P, _P, _P, _P, _L, _I, _P),
    # q q_bf16 k v kv_bf16 out part_m part_l part_acc counters B S H Hkv d
    # length n_split chunk scale softcap stream
    "decode_attn": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                    _I, _I, _I, _I, _F, _F, _P),
    # q_bf16 kv_bf16 d G blocks_per_sm (int*)
    "decode_attn_plan": (_I, _I, _I, _I, _P),
    # x dt a b c d y B T D N stream
    "selective_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # x dt a b c d gy gx gdt ga_part gb_part gc_part gd_part ckpt B T D N
    # stream
    "selective_scan_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _I, _I, _I, _I, _P),
    # x dt_raw dt_bias z z_sb z_st a b c d y y_pre B T D N bf16 stream
    "selective_scan_gated": (_P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _P),
    # x dt_raw dt_bias z z_sb z_st y_pre a b c d g gx g_raw gz ga_part
    # gb_part gc_part gd_part gbias_part ckpt B T D N bf16 stream
    "selective_scan_gated_bwd": (_P, _P, _P, _P, _L, _L, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _P),
    # N gated bf16 blocks_per_sm (int*)
    "selective_scan_bwd_occupancy": (_I, _I, _I, _P),
    # q k v out lse B Sq Skv H Hkv d bf16 causal window scale softcap stream
    "flash_attn_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _I, _F, _F, _P),
    # q k v o dout lse delta dq B Sq Skv H Hkv d bf16 causal window scale
    # softcap stream
    "flash_attn_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _F, _F, _P),
    # q k v dout lse delta dk dv B Sq Skv H Hkv d bf16 causal window scale
    # softcap stream
    "flash_attn_bwd_dkdv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _F, _F, _P),
    # fcodes acodes valid dict n lo hi psum pcnt n_parts counter out_sum
    # out_cnt stream
    "scan_float": (_P, _P, _P, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _P),
    # vec blocks_per_sm (int*)
    "scan_float_occupancy": (_I, _P),
    # table(host) n_leaves bf16 master b1 c1 b2 c2 eps wd lr bc1 bc2 stream
    "adamw_update": (_P, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _P, _P, _P),
    # x sb sx w b y B T D K bf16 stream
    "causal_conv_fwd": (_P, _L, _L, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # x sb sx w b gy dx part dw db B T D K bf16 stream
    "causal_conv_bwd": (_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _P),
    # bwd bf16 blocks_per_sm (int*)
    "causal_conv_occupancy": (_I, _I, _P),
}

_lib: ctypes.CDLL | None = None
_entries: dict = {}                # C entry name -> bound function
_one_device: bool | None = None    # one CUDA device in the process
_build_seconds: float | None = None
_build_log: str = ""


def build_dir() -> pathlib.Path:
    """``build/`` at the checkout's root (``src/repro_torch/kernels`` is
    three levels below it); beside the working directory for an installed
    package."""
    here = pathlib.Path(__file__).resolve()
    root = here.parents[3] if here.parents[2].name == "src" else pathlib.Path.cwd()
    return root / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under "
                       f"{home}); the CUDA kernels cannot be built here")


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _content_hash(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in list(sources) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Start every command together, wait for all, raise with the
    compilers' output if any failed; returns the combined output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed, log = [], []
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"$ {' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return "".join(log)


def build_library(verbose_ptxas: bool = False) -> pathlib.Path:
    """Compile (if needed) and return the shared library's path."""
    global _build_seconds, _build_log
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    out_dir = build_dir()
    lib_path = out_dir / f"librepro_torch_kernels_{_content_hash(sources)}.so"
    if lib_path.exists():
        _build_seconds = 0.0
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    extra = ["-Xptxas", "-v"] if verbose_ptxas else []
    objs = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources]
    _build_log = _run_all([[nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-c",
                            str(src), "-o", str(obj)]
                           for src, obj in zip(sources, objs)])
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    os.replace(tmp, lib_path)          # atomic: a reader never sees half
    for obj in objs:
        obj.unlink(missing_ok=True)
    _build_seconds = time.perf_counter() - t0
    return lib_path


def load_library() -> ctypes.CDLL:
    """The bound library (built at first use, then cached in the process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def entry(name: str):
    """The bound C entry `name` (looked up once)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(load_library(), name)
    return fn


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` with `args` and the raw handle of `device`'s
    current stream, then raise on a CUDA error. The handle is an int from
    ``torch._C._cuda_getCurrentRawStream`` (no ``torch.cuda.Stream`` object
    is made); ``torch.cuda.device`` guards the call only when `device` is
    not the current device, which is never the case with one device.
    `device` is a CUDA device with its index, as ``tensor.device`` gives
    it."""
    global _one_device
    fn = _entries.get(name) or entry(name)
    idx = device.index
    if _one_device is None:
        _one_device = torch.cuda.device_count() == 1
    if _one_device or idx == torch._C._cuda_getDevice():
        code = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            code = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if code:
        check(code, name)


def build_log() -> str:
    """What the compilers printed during the last build in this process
    (register and shared-memory use with ``verbose_ptxas=True``)."""
    return _build_log


def build_seconds() -> float | None:
    """Seconds the last build in this process took (0.0 when the library
    was found built, None before the first load)."""
    return _build_seconds


def check(code: int, entry: str) -> None:
    """Raise when a C entry reports a CUDA error (a refused launch never
    runs and a later synchronise would not report it)."""
    if code != 0:
        msg = load_library().cuda_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel entry {entry!r} failed: {msg} "
                           f"(cudaError {code})")
