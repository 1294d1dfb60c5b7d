"""The port's native host code: the SMO solvers and the DAG topology scan.

Port of ``stem_kernel_tpu/native``.  The C++ sources of this directory are
built by ``native.build`` (plain g++, no other dependency) at their first
use and loaded with ctypes.  Unlike the JAX package, nothing here falls
back: the library is built, or the call raises.  The numpy SMO
(``svm.solver.smo_solve_numpy``) and the Python scan
(``models.dag._dag_topology_python``) stay as the plain versions.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built library with argtypes declared for every entry point."""
    from .build import build

    lib = ctypes.CDLL(str(build()))
    dptr = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    fptr = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    dout = ctypes.POINTER(ctypes.c_double)
    lout = ctypes.POINTER(ctypes.c_long)
    # (K, y, p, n, C_p, C_n, eps, max_iter, alpha, rho, obj, iters)
    for name, kptr in (("smo_solve", dptr), ("smo_solve_f32", fptr)):
        fn = getattr(lib, name)
        fn.argtypes = [kptr, dptr, dptr, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                       ctypes.c_double, ctypes.c_long, dptr, dout, dout, lout]
        fn.restype = ctypes.c_int
    # (K, y, p, n, C_p, C_n, alpha0, eps, max_iter, alpha, rho, r, obj, iters)
    for name, kptr in (("smo_solve_nu", dptr), ("smo_solve_nu_f32", fptr)):
        fn = getattr(lib, name)
        fn.argtypes = [kptr, dptr, dptr, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                       dptr, ctypes.c_double, ctypes.c_long, dptr, dout, dout, dout, lout]
        fn.restype = ctypes.c_int
    lib.dag_build.argtypes = [dptr, ctypes.c_int, ctypes.c_double]
    lib.dag_build.restype = ctypes.c_void_p
    lib.dag_sizes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                              ctypes.POINTER(ctypes.c_int)]
    lib.dag_sizes.restype = None
    lib.dag_copy.argtypes = [ctypes.c_void_p, iptr, iptr, iptr, iptr, iptr]
    lib.dag_copy.restype = None
    lib.dag_free.argtypes = [ctypes.c_void_p]
    lib.dag_free.restype = None
    return lib


def _smo_inputs(K, y, p, vecs=()):
    """K as float32 or float64 (a float32 Gram is not copied to f64: that
    copy cost 50x the solve at n = 30k in the JAX package), the vectors as
    contiguous f64, all checked against n."""
    K = np.asarray(K)
    dtype = np.float32 if K.dtype == np.float32 else np.float64
    K = np.ascontiguousarray(K, dtype=dtype)
    n = len(y)
    out = [np.ascontiguousarray(v, dtype=np.float64) for v in (y, p, *vecs)]
    if K.shape != (n, n) or any(v.shape != (n,) for v in out):
        raise ValueError(f"SMO inputs: K {K.shape} and vectors "
                         f"{[v.shape for v in out]} for n = {n}")
    return K, out


def smo_solve_native(K, y, p, C_p, C_n, eps, max_iter):
    """C-SVC SMO from alpha = 0: (alpha, rho, obj, n_iter)."""
    lib = load_library()
    K, (y, p) = _smo_inputs(K, y, p)
    n = len(y)
    alpha = np.zeros(n, dtype=np.float64)
    rho, obj, it = ctypes.c_double(), ctypes.c_double(), ctypes.c_long()
    fn = lib.smo_solve_f32 if K.dtype == np.float32 else lib.smo_solve
    fn(K, y, p, n, C_p, C_n, eps, int(max_iter), alpha,
       ctypes.byref(rho), ctypes.byref(obj), ctypes.byref(it))
    return alpha, rho.value, obj.value, it.value


def smo_solve_nu_native(K, y, p, C_p, C_n, alpha0, eps, max_iter):
    """nu-formulation SMO from the feasible ``alpha0``: (alpha, rho, r, obj, n_iter)."""
    lib = load_library()
    K, (y, p, a0) = _smo_inputs(K, y, p, (alpha0,))
    n = len(y)
    alpha = np.zeros(n, dtype=np.float64)
    rho, r, obj, it = ctypes.c_double(), ctypes.c_double(), ctypes.c_double(), ctypes.c_long()
    fn = lib.smo_solve_nu_f32 if K.dtype == np.float32 else lib.smo_solve_nu
    fn(K, y, p, n, C_p, C_n, a0, eps, int(max_iter), alpha,
       ctypes.byref(rho), ctypes.byref(r), ctypes.byref(obj), ctypes.byref(it))
    return alpha, rho.value, r.value, obj.value, it.value


def dag_scan_native(bpp, th):
    """Node spans and CSR edges of the thresholded (L, L) base-pair matrix:
    (first, last, edge_to, edge_gaps, edge_ptr), int32."""
    lib = load_library()
    bpp = np.ascontiguousarray(bpp, dtype=np.float64)
    if bpp.ndim != 2 or bpp.shape[0] != bpp.shape[1]:
        raise ValueError(f"dag_scan_native: a square matrix, not {bpp.shape}")
    h = lib.dag_build(bpp, bpp.shape[0], th)
    try:
        n_nodes, n_edges = ctypes.c_int(), ctypes.c_int()
        lib.dag_sizes(h, ctypes.byref(n_nodes), ctypes.byref(n_edges))
        first = np.zeros(n_nodes.value, np.int32)
        last = np.zeros(n_nodes.value, np.int32)
        edge_to = np.zeros(max(n_edges.value, 1), np.int32)
        edge_gaps = np.zeros(max(n_edges.value, 1), np.int32)
        edge_ptr = np.zeros(n_nodes.value + 1, np.int32)
        lib.dag_copy(h, first, last, edge_to, edge_gaps, edge_ptr)
    finally:
        lib.dag_free(h)
    return first, last, edge_to[: n_edges.value], edge_gaps[: n_edges.value], edge_ptr
