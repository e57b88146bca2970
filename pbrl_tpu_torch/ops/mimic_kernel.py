"""The policy-step kernel: wrapper, build and plain version.

Counterpart of ``pbrl_tpu/ops/mimic_kernel.py``. ``build_mimic_step``
keeps the JAX signature and returns ``(step, spec)``; ``step(qpos (B,nq),
qvel (B,nv), u (B,nu)) -> (qpos', qvel', xpos (B,nbody,3), xquat
(B,nbody,4), fall (B,))`` advances every env by one policy step
(``n_substeps`` physics substeps, then the final-pose FK; ``fall`` is the
max over substeps).

For CUDA tensors the step launches ``csrc/mimic_step.cu`` (one warp per
env; working state and the hot index tables in shared memory), built with
``nvcc`` for ``sm_90a`` into ``build/pbrl_tpu_torch/`` at first use and
bound with ``ctypes``. The kernel reads and writes the env's (B, K) rows as
they are: no transposes. For CPU tensors it runs the plain version,
:func:`mimic_step_plain`, built from the field program in
:mod:`pbrl_tpu_torch.ops.field_physics`. Nothing falls back from one to
the other: a build or launch failure raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Sequence

import numpy as np
import torch

from pbrl_tpu_torch.model.spec import Model
from pbrl_tpu_torch.ops import field_physics as fp

SOURCE = fp.KERNEL_SOURCE
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "pbrl_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def mimic_step_plain(spec: fp.SubstepSpec, qpos: torch.Tensor, qvel: torch.Tensor,
                     u: torch.Tensor):
    """The policy step in plain PyTorch, on any device: substep 0 solves
    the self-contact masses, substeps 1..n-1 reuse them (as
    ``pbrl_tpu.ops.mimic_kernel._kernel`` does), then ``fk_outputs``."""
    B = qpos.shape[0]
    q = list(qpos.t().contiguous().to(torch.float32).unbind(0))
    v = list(qvel.t().contiguous().to(torch.float32).unbind(0))
    target = list(u.t().contiguous().to(torch.float32).unbind(0))
    q, v, fall, held = fp.substep(spec, q, v, target)
    held = held or None
    for _ in range(1, spec.n_substeps):
        q, v, f, _ = fp.substep(spec, q, v, target, held_self=held)
        fall = torch.maximum(fall, f)
    xpos, xquat = fp.fk_outputs(spec, q)
    return (torch.stack(q, 1), torch.stack(v, 1),
            torch.stack([torch.stack(p, 1) for p in xpos], 1).reshape(B, spec.nbody, 3),
            torch.stack([torch.stack(r, 1) for r in xquat], 1).reshape(B, spec.nbody, 4),
            fall)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "csrc/mimic_step.cu")
    return found


@functools.lru_cache(maxsize=None)
def build_library():
    """Compile the kernel (once per source content) and load it.

    Returns ``(ctypes.CDLL, build record)``; the record holds the library
    path, the build seconds (0 when an existing build was reused) and the
    ``-Xptxas -v`` report.
    """
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, f"libmimic_step_{digest}.so")
    log_path = lib_path[:-3] + ".log"
    seconds = 0.0
    if not os.path.exists(lib_path):
        # build under a unique name, then rename: a build cut off halfway
        # leaves no file that a later run would load
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
        with open(log_path, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    with open(log_path) as f:
        report = f.read()
    lib = ctypes.CDLL(lib_path)
    bind(lib)
    lib.mimic_step_launch.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 9
    lib.mimic_step_launch.restype = ctypes.c_int
    lib.mimic_step_occupancy.argtypes = [ctypes.c_void_p]
    lib.mimic_step_occupancy.restype = ctypes.c_int
    return lib, {"path": lib_path, "seconds": seconds, "ptxas": report}


def occupancy() -> dict:
    """The kernel's widest block (the staged table and the envs' working
    state in shared memory) and how many of them one SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) on the current card."""
    lib, _ = build_library()
    out = np.zeros(6, np.int32)
    err = lib.mimic_step_occupancy(out.ctypes.data)
    if err != 0:
        raise RuntimeError(f"mimic_step occupancy query failed: cudaError {err}")
    blocks, threads, smem, envs, lanes, staged = out.tolist()
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * threads // 32,
            "envs_per_sm": blocks * envs, "threads_per_block": threads,
            "smem_per_block": smem, "staged_table_bytes": staged,
            "work_bytes_per_env": (smem - staged) // envs, "envs_per_block": envs,
            "lanes_per_env": lanes}


def bind(lib) -> None:
    """Declare the table entry points of a loaded build and check that its
    ``Model`` layout is the one ``field_physics.pack_spec`` writes."""
    lib.mimic_model_words.restype = ctypes.c_int
    lib.mimic_model_names.restype = ctypes.c_char_p
    lib.mimic_model_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.mimic_model_offsets.restype = ctypes.c_int
    layout, size = fp.table_layout()
    names = lib.mimic_model_names().decode().rstrip(",").split(",")
    offs = np.zeros(len(layout) + 8, np.int32)
    n = lib.mimic_model_offsets(offs.ctypes.data, len(offs))
    want = [(name, off) for _, name, off, _ in layout]
    got = list(zip(names, offs[:n].tolist()))
    if got != want or lib.mimic_model_words() != size:
        raise RuntimeError("the built kernel's table layout differs from its source's")


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------


class MimicStep:
    """Callable policy step for one model configuration.

    ``launches`` counts kernel launches (CUDA tensors only).
    """

    def __init__(self, spec: fp.SubstepSpec):
        self.spec = spec
        self.table = fp.pack_spec(spec)
        self.launches = 0
        self._device_tables = {}

    def __call__(self, qpos: torch.Tensor, qvel: torch.Tensor, u: torch.Tensor):
        spec = self.spec
        B = qpos.shape[0]
        if spec.nu == 0:
            u = torch.zeros((B, 1), dtype=qpos.dtype, device=qpos.device)
        self._check(qpos, qvel, u)
        if qpos.device.type == "cpu":
            return mimic_step_plain(spec, qpos, qvel, u)
        if qpos.device.type != "cuda":
            raise ValueError(f"mimic_step runs on cuda or cpu tensors, not {qpos.device}")
        return self._launch(qpos, qvel, u)

    def _check(self, qpos, qvel, u):
        spec = self.spec
        B = qpos.shape[0]
        want = ((qpos, (B, spec.nq)), (qvel, (B, spec.nv)), (u, (B, max(spec.nu, 1))))
        for t, shape in want:
            if tuple(t.shape) != shape:
                raise ValueError(f"expected shape {shape}, got {tuple(t.shape)}")
            if t.dtype != torch.float32:
                raise ValueError(f"expected float32, got {t.dtype}")
            if t.device != qpos.device:
                raise ValueError("qpos, qvel and u must be on one device")
            if not t.is_contiguous():
                raise ValueError("inputs must be contiguous")

    def _launch(self, qpos, qvel, u):
        spec = self.spec
        dev = qpos.device
        if torch.cuda.get_device_capability(dev) != (9, 0):
            raise RuntimeError("the kernel is built for sm_90a (Hopper)")
        lib, _ = build_library()
        key = str(dev)
        if key not in self._device_tables:
            self._device_tables[key] = torch.from_numpy(self.table).to(dev)
        table = self._device_tables[key]
        B = qpos.shape[0]
        nb = spec.nbody
        out = (torch.empty((B, spec.nq), dtype=torch.float32, device=dev),
               torch.empty((B, spec.nv), dtype=torch.float32, device=dev),
               torch.empty((B, nb, 3), dtype=torch.float32, device=dev),
               torch.empty((B, nb, 4), dtype=torch.float32, device=dev),
               torch.empty((B,), dtype=torch.float32, device=dev))
        if B == 0:  # nothing to launch
            return out
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):  # the launch shape is worked out for the current device
            err = lib.mimic_step_launch(table.data_ptr(), B, qpos.data_ptr(), qvel.data_ptr(),
                                        u.data_ptr(), *[t.data_ptr() for t in out], stream)
        if err != 0:
            raise RuntimeError(f"mimic_step launch failed: cudaError {err}")
        self.launches += 1
        return out


def build_mimic_step(
    model: Model,
    kp=None,
    kd=None,
    n_substeps: int = 8,
    mode: str = "pd",
    fall_allowed_bodies: Sequence[str] = (),
    torque_scale: float = 1.0,
):
    """Returns ``(step, spec)``: ``step`` is a :class:`MimicStep`."""
    spec = fp.build_spec(model, kp=kp, kd=kd, n_substeps=n_substeps, mode=mode,
                         fall_allowed_bodies=fall_allowed_bodies,
                         torque_scale=torque_scale)
    return MimicStep(spec), spec
