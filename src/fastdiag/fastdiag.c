/* fastdiag: native batched MCMC diagnostics.
 *
 * The framework computes draws on-device; diagnostics post-processing
 * (R-hat / ESS over a (chains, draws, params) tensor that can reach
 * hundreds of MB for the large benchmarks) runs on host. This module is the
 * native engine for that path: OpenMP across parameters, direct
 * autocovariance with Geyer early termination per lag (the initial-positive-
 * sequence cutoff is typically << chain length, so direct O(n * lag_cut)
 * beats a full FFT and allocates nothing).
 *
 * Exposes:
 *   ess(buffer, chains, draws, params)  -> list[float] length params
 *   rhat(buffer, chains, draws, params) -> list[float] length params (split R-hat)
 *
 * `buffer` is any C-contiguous float64 buffer of shape (chains, draws,
 * params) flattened; numpy arrays pass via the buffer protocol, no numpy C
 * API needed. Semantics match mlx_mcmc_tpu/diagnostics/stats.py (the pure
 * numpy reference, which remains the fallback when this extension is not
 * built).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <math.h>
#include <stdlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* Effective sample size for one parameter column.
 * x is strided: value(c, t) = col[c * draws * params + t * params]. */
static double ess_one(const double *col, Py_ssize_t chains, Py_ssize_t draws,
                      Py_ssize_t params, double *scratch) {
  const Py_ssize_t m = chains, n = draws;
  if (n < 4) return NAN;

  /* scratch layout: demeaned draws (m*n), chain means (m), chain vars (m) */
  double *d = scratch;
  double *cmean = scratch + m * n;
  double *cvar = cmean + m;

  for (Py_ssize_t c = 0; c < m; ++c) {
    const double *row = col + (size_t)c * n * params;
    double s = 0.0;
    for (Py_ssize_t t = 0; t < n; ++t) s += row[(size_t)t * params];
    double mu = s / (double)n;
    cmean[c] = mu;
    double v = 0.0;
    for (Py_ssize_t t = 0; t < n; ++t) {
      double dv = row[(size_t)t * params] - mu;
      d[c * n + t] = dv;
      v += dv * dv;
    }
    cvar[c] = v / (double)(n - 1);
  }

  double W = 0.0;
  for (Py_ssize_t c = 0; c < m; ++c) W += cvar[c];
  W /= (double)m;

  double var_plus = W * (double)(n - 1) / (double)n;
  if (m > 1) {
    double gm = 0.0;
    for (Py_ssize_t c = 0; c < m; ++c) gm += cmean[c];
    gm /= (double)m;
    double B = 0.0;
    for (Py_ssize_t c = 0; c < m; ++c) {
      double dm = cmean[c] - gm;
      B += dm * dm;
    }
    var_plus += B / (double)(m - 1);
  }
  if (!(var_plus > 0.0)) return NAN;

  /* rho_t on demand; Geyer pair accumulation with early termination and
   * monotone enforcement. rho_0 = 1 by construction. */
  double tau_acc = 0.0; /* sum of kept pairs */
  double prev_pair = INFINITY;
  Py_ssize_t max_pairs = n / 2;
  for (Py_ssize_t k = 0; k < max_pairs; ++k) {
    double pair = 0.0;
    for (int half = 0; half < 2; ++half) {
      Py_ssize_t t = 2 * k + half;
      double rho;
      if (t == 0) {
        rho = 1.0;
      } else if (t >= n) {
        rho = 0.0;
      } else {
        double acov = 0.0;
        for (Py_ssize_t c = 0; c < m; ++c) {
          const double *dc = d + c * n;
          double s = 0.0;
          for (Py_ssize_t i = 0; i + t < n; ++i) s += dc[i] * dc[i + t];
          acov += s / (double)n;
        }
        acov /= (double)m;
        rho = 1.0 - (W - acov) / var_plus;
      }
      pair += rho;
    }
    if (pair <= 0.0) break;
    if (pair > prev_pair) pair = prev_pair; /* monotone non-increasing */
    prev_pair = pair;
    tau_acc += pair;
  }
  double tau = -1.0 + 2.0 * tau_acc;
  if (tau < 1e-12) tau = 1e-12;
  double ess = (double)(m * n) / tau;
  double total = (double)(m * n);
  double cap = total * log10(total < 10.0 ? 10.0 : total);
  return ess < cap ? ess : cap;
}

/* Split R-hat for one parameter column (split each chain in half). */
static double rhat_one(const double *col, Py_ssize_t chains, Py_ssize_t draws,
                       Py_ssize_t params) {
  const Py_ssize_t half = draws / 2;
  const Py_ssize_t m = chains * 2, n = half;
  if (n < 2) return NAN;

  double W = 0.0, gmean = 0.0;
  /* chain means/vars computed in two passes without scratch */
  double *means = (double *)malloc(sizeof(double) * (size_t)m);
  if (!means) return NAN;
  for (Py_ssize_t s = 0; s < m; ++s) {
    Py_ssize_t c = s % chains;
    Py_ssize_t off = (s / chains) * half; /* 0 or half */
    const double *row = col + (size_t)c * draws * params;
    double mu = 0.0;
    for (Py_ssize_t t = 0; t < n; ++t) mu += row[(size_t)(off + t) * params];
    mu /= (double)n;
    means[s] = mu;
    gmean += mu;
    double v = 0.0;
    for (Py_ssize_t t = 0; t < n; ++t) {
      double dv = row[(size_t)(off + t) * params] - mu;
      v += dv * dv;
    }
    W += v / (double)(n - 1);
  }
  W /= (double)m;
  gmean /= (double)m;
  double B = 0.0;
  for (Py_ssize_t s = 0; s < m; ++s) {
    double dm = means[s] - gmean;
    B += dm * dm;
  }
  B = B * (double)n / (double)(m - 1);
  free(means);
  if (!(W > 0.0)) return NAN;
  double var_plus = ((double)(n - 1) / (double)n) * W + B / (double)n;
  return sqrt(var_plus / W);
}

static int get_3d_buffer(PyObject *obj, Py_buffer *view, Py_ssize_t chains,
                         Py_ssize_t draws, Py_ssize_t params) {
  if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0)
    return -1;
  if (view->itemsize != (Py_ssize_t)sizeof(double) ||
      (view->format && view->format[0] != 'd')) {
    PyBuffer_Release(view);
    PyErr_SetString(PyExc_TypeError, "expected float64 buffer");
    return -1;
  }
  if (view->len != (Py_ssize_t)(chains * draws * params * sizeof(double))) {
    PyBuffer_Release(view);
    PyErr_SetString(PyExc_ValueError, "buffer size != chains*draws*params");
    return -1;
  }
  return 0;
}

static PyObject *py_ess(PyObject *self, PyObject *args) {
  PyObject *obj;
  Py_ssize_t chains, draws, params;
  if (!PyArg_ParseTuple(args, "Onnn", &obj, &chains, &draws, &params))
    return NULL;
  Py_buffer view;
  if (get_3d_buffer(obj, &view, chains, draws, params) != 0) return NULL;
  const double *base = (const double *)view.buf;

  double *out = (double *)malloc(sizeof(double) * (size_t)params);
  if (!out) {
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
  }

  Py_BEGIN_ALLOW_THREADS
#ifdef _OPENMP
#pragma omp parallel
  {
    double *scratch =
        (double *)malloc(sizeof(double) * (size_t)(chains * draws + 2 * chains));
#pragma omp for schedule(dynamic)
    for (Py_ssize_t p = 0; p < params; ++p)
      out[p] = scratch ? ess_one(base + p, chains, draws, params, scratch) : NAN;
    free(scratch);
  }
#else
  {
    double *scratch =
        (double *)malloc(sizeof(double) * (size_t)(chains * draws + 2 * chains));
    for (Py_ssize_t p = 0; p < params; ++p)
      out[p] = scratch ? ess_one(base + p, chains, draws, params, scratch) : NAN;
    free(scratch);
  }
#endif
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&view);
  PyObject *list = PyList_New(params);
  if (!list) {
    free(out);
    return NULL;
  }
  for (Py_ssize_t p = 0; p < params; ++p)
    PyList_SET_ITEM(list, p, PyFloat_FromDouble(out[p]));
  free(out);
  return list;
}

static PyObject *py_rhat(PyObject *self, PyObject *args) {
  PyObject *obj;
  Py_ssize_t chains, draws, params;
  if (!PyArg_ParseTuple(args, "Onnn", &obj, &chains, &draws, &params))
    return NULL;
  Py_buffer view;
  if (get_3d_buffer(obj, &view, chains, draws, params) != 0) return NULL;
  const double *base = (const double *)view.buf;

  double *out = (double *)malloc(sizeof(double) * (size_t)params);
  if (!out) {
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
  }

  Py_BEGIN_ALLOW_THREADS
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (Py_ssize_t p = 0; p < params; ++p)
    out[p] = rhat_one(base + p, chains, draws, params);
  Py_END_ALLOW_THREADS

  PyBuffer_Release(&view);
  PyObject *list = PyList_New(params);
  if (!list) {
    free(out);
    return NULL;
  }
  for (Py_ssize_t p = 0; p < params; ++p)
    PyList_SET_ITEM(list, p, PyFloat_FromDouble(out[p]));
  free(out);
  return list;
}

static PyMethodDef Methods[] = {
    {"ess", py_ess, METH_VARARGS,
     "ess(f64_buffer, chains, draws, params) -> list of ESS per param"},
    {"rhat", py_rhat, METH_VARARGS,
     "rhat(f64_buffer, chains, draws, params) -> list of split R-hat per param"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastdiag",
    "Native batched MCMC diagnostics (OpenMP).", -1, Methods,
};

PyMODINIT_FUNC PyInit__fastdiag(void) { return PyModule_Create(&moduledef); }
