// gcmce_* C ABI of icebin_tpu_torch: the Fortran-GCM-facing coupler
// boundary, driving the PyTorch + CUDA port.
//
// ModelE's Fortran LISnow code calls C functions (gcmce_new,
// gcmce_set_start_time, gcmce_add_gcm_outpute, gcmce_couple_native)
// implemented in the reference's GCMCoupler_ModelE.cpp [U] (SURVEY.md
// sections 2, 3.3, 3.5).  This library exports the same functions with the
// same signatures as native/gcmce.cc, so a GCM relinks against it without a
// source change.  It embeds CPython and forwards to
// icebin_tpu_torch.models.gcmce_shim, which runs the port's coupler on the
// card (gcmce_new refuses to run without one).
//
// Errors: gcmce_new returns a negative handle, and prints the Python error,
// when the shim raises; gcmce_dims and gcmce_couple_native return -1.
//
// Threading: every entry ensures the GIL (a Fortran GCM may call from any
// thread; ctypes test harnesses release the GIL around foreign calls).
//
// Build: icebin_tpu_torch/ops/_build_gcmce.py compiles this file at first
// use with g++ and the flags of `python3-config --includes --ldflags
// --embed`, into build/icebin_tpu_torch/.

#include <Python.h>

#include <cstdint>
#include <cstdio>

namespace {

PyObject* shim() {
  static PyObject* mod = nullptr;
  if (!mod) {
    mod = PyImport_ImportModule("icebin_tpu_torch.models.gcmce_shim");
    if (!mod) PyErr_Print();
  }
  return mod;
}

// Starts the interpreter on a GCM's first call; a Python process that
// loads this library through ctypes already runs one.
struct Gil {
  PyGILState_STATE st;
  Gil() {
    if (!Py_IsInitialized()) Py_InitializeEx(0);
    st = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(st); }
};

long call_long(PyObject* r, long fallback) {
  if (!r) {
    PyErr_Print();
    return fallback;
  }
  long v = PyLong_Check(r) ? PyLong_AsLong(r) : fallback;
  Py_DECREF(r);
  return v;
}

}  // namespace

extern "C" {

int gcmce_new(const char* config_json_path) {
  Gil g;
  PyObject* m = shim();
  if (!m) return -1;
  PyObject* r = PyObject_CallMethod(m, "gcmce_new", "s", config_json_path);
  return static_cast<int>(call_long(r, -1));
}

void gcmce_delete(int h) {
  Gil g;
  PyObject* m = shim();
  if (!m) return;
  PyObject* r = PyObject_CallMethod(m, "gcmce_delete", "i", h);
  if (!r) PyErr_Print();
  Py_XDECREF(r);
}

int gcmce_dims(int h, int* im, int* jm, int* nhc) {
  Gil g;
  PyObject* m = shim();
  if (!m) return -1;
  PyObject* r = PyObject_CallMethod(m, "gcmce_dims", "i", h);
  if (!r) {
    PyErr_Print();
    return -1;
  }
  int ok = PyArg_ParseTuple(r, "iii", im, jm, nhc) ? 0 : -1;
  if (ok != 0) PyErr_Print();
  Py_DECREF(r);
  return ok;
}

void gcmce_set_start_time(int h, double t0) {
  Gil g;
  PyObject* m = shim();
  if (!m) return;
  PyObject* r = PyObject_CallMethod(m, "gcmce_set_start_time", "id", h, t0);
  if (!r) PyErr_Print();
  Py_XDECREF(r);
}

// idx: (n,) int64 ModelE ihc-major E indices; vals: (nvar, n) f64.
void gcmce_add_gcm_outpute(int h, const int64_t* idx, const double* vals,
                           int64_t n, int nvar) {
  Gil g;
  PyObject* m = shim();
  if (!m) return;
  PyObject* mv_i = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<int64_t*>(idx)), n * 8, PyBUF_READ);
  PyObject* mv_v = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<double*>(vals)), n * nvar * 8,
      PyBUF_READ);
  PyObject* r = mv_i && mv_v
                    ? PyObject_CallMethod(m, "gcmce_add_gcm_outpute", "iOOLi",
                                          h, mv_i, mv_v, (long long)n, nvar)
                    : nullptr;
  if (!r) PyErr_Print();
  Py_XDECREF(r);
  Py_XDECREF(mv_i);
  Py_XDECREF(mv_v);
}

// fhc/elevE: (nhc*jm*im) f64 out; underice: (nhc*jm*im) int32 out.
int gcmce_couple_native(int h, double itime, double* fhc, double* elevE,
                        int32_t* underice, int64_t ncells_e) {
  Gil g;
  PyObject* m = shim();
  if (!m) return -1;
  PyObject* mv_f = PyMemoryView_FromMemory(reinterpret_cast<char*>(fhc),
                                           ncells_e * 8, PyBUF_WRITE);
  PyObject* mv_e = PyMemoryView_FromMemory(reinterpret_cast<char*>(elevE),
                                           ncells_e * 8, PyBUF_WRITE);
  PyObject* mv_u = PyMemoryView_FromMemory(reinterpret_cast<char*>(underice),
                                           ncells_e * 4, PyBUF_WRITE);
  PyObject* r = mv_f && mv_e && mv_u
                    ? PyObject_CallMethod(m, "gcmce_couple_native", "idOOO",
                                          h, itime, mv_f, mv_e, mv_u)
                    : nullptr;
  long rc = call_long(r, -1);
  Py_XDECREF(mv_f);
  Py_XDECREF(mv_e);
  Py_XDECREF(mv_u);
  return static_cast<int>(rc);
}

}  // extern "C"
