// Training-side LGBM_* C ABI of lightgbm_tpu_torch — hosts the CPython
// runtime.
//
// The reference exposes its full training workflow as ~50 C functions
// (include/LightGBM/c_api.h:37-711) implemented over its C++ core
// (src/c_api.cpp).  Here the training core is Python/PyTorch — its
// learners drive hand-written CUDA kernels from the host loop — so this
// ABI embeds the CPython interpreter and delegates to the marshaling
// shim `lightgbm_tpu_torch.capi`: every function here only moves
// scalars, pointers (passed to Python as integer addresses), and
// strings.  Array memory is wrapped zero-copy on the Python side via
// ctypes.  A copy of src/native/c_api_train.cpp, the JAX package's ABI,
// with the shim's module name changed.
//
// Two usage modes:
//   * loaded into an existing Python process (ctypes): the interpreter
//     is already live, PyGILState_Ensure just takes the GIL
//     (tests/test_torch_capi.py, chip_smoke.py);
//   * embedded in a plain C/C++ host: the first call initializes the
//     interpreter (set PYTHONPATH so `lightgbm_tpu_torch` imports).
//
// Built by lightgbm_tpu_torch/native.py (train_lib) into
// build/native/liblgbt_train_torch_<hash>.so; it links libpython where
// the interpreter has a shared one.  The inference ABI
// (src/native/c_api.cpp, in liblgbt_native_torch) stays
// dependency-free.
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_last_error = "Everything is fine";

// Interpreter bootstrap. When THIS library starts the interpreter we
// release the GIL immediately afterwards so that every entry point can
// uniformly use PyGILState_Ensure/Release.
void ensure_interpreter() {
  // call_once: two embedding-host threads must not both pass the
  // Py_IsInitialized() check and double-initialize
  static std::once_flag once;
  std::call_once(once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();
    }
  });
}

class Gil {
 public:
  Gil() {
    ensure_interpreter();
    state_ = PyGILState_Ensure();
  }
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// Borrowed reference to the shim module, imported once per process.
PyObject* shim() {
  static PyObject* mod = nullptr;
  if (mod == nullptr) {
    mod = PyImport_ImportModule("lightgbm_tpu_torch.capi");
  }
  return mod;
}

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  g_last_error = "unknown python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) g_last_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
}

// Call shim.<fn>(...) with a CPython arg-format string.  Returns a NEW
// reference or nullptr (python error already captured).
PyObject* call_shim(const char* fn, const char* fmt, ...) {
  if (shim() == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(shim(), fn);
  if (f == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject* args = Py_VaBuildValue(fmt, va);
  va_end(va);
  PyObject* res = nullptr;
  if (args != nullptr) {
    res = PyObject_CallObject(f, args);
    Py_DECREF(args);
  }
  Py_DECREF(f);
  if (res == nullptr) set_error_from_python();
  return res;
}

// Call a METHOD on a handle object.
PyObject* call_method(void* handle, const char* name, const char* fmt, ...) {
  PyObject* obj = reinterpret_cast<PyObject*>(handle);
  if (obj == nullptr) {
    g_last_error = "null handle";
    return nullptr;
  }
  PyObject* f = PyObject_GetAttrString(obj, name);
  if (f == nullptr) {
    set_error_from_python();
    return nullptr;
  }
  va_list va;
  va_start(va, fmt);
  PyObject* args = (fmt != nullptr && fmt[0] != '\0')
                       ? Py_VaBuildValue(fmt, va)
                       : PyTuple_New(0);
  va_end(va);
  PyObject* res = nullptr;
  if (args != nullptr) {
    if (!PyTuple_Check(args)) {          // single-arg format like "i"
      PyObject* t = PyTuple_Pack(1, args);
      Py_DECREF(args);
      args = t;
    }
    if (args != nullptr) {
      res = PyObject_CallObject(f, args);
      Py_DECREF(args);
    }
  }
  Py_DECREF(f);
  if (res == nullptr) set_error_from_python();
  return res;
}

int handle_out(PyObject* res, void** out) {
  if (res == nullptr) return -1;
  *out = res;  // ownership transferred to the C caller until *Free
  return 0;
}

int int_out(PyObject* res, int* out) {
  if (res == nullptr) return -1;
  *out = static_cast<int>(PyLong_AsLong(res));
  Py_DECREF(res);
  return 0;
}

int void_out(PyObject* res) {
  if (res == nullptr) return -1;
  Py_DECREF(res);
  return 0;
}

// Copy a python str into the reference's (buffer_len, out_len, out_str)
// contract: *out_len is the needed size incl. NUL; copy happens only
// when the caller's buffer is large enough (c_api.cpp SaveModelToString).
int string_out(PyObject* res, int buffer_len, int* out_len, char* out_str) {
  if (res == nullptr) return -1;
  Py_ssize_t n = 0;
  const char* c = PyUnicode_AsUTF8AndSize(res, &n);
  if (c == nullptr) {
    set_error_from_python();
    Py_DECREF(res);
    return -1;
  }
  *out_len = static_cast<int>(n) + 1;
  if (buffer_len >= *out_len && out_str != nullptr) {
    std::memcpy(out_str, c, static_cast<size_t>(n) + 1);
  }
  Py_DECREF(res);
  return 0;
}

// Copy a python list[str] into a caller-preallocated char** array.
// The contract (c_api.h:446-454) has no per-name buffer length; names
// are truncated to 255 chars + NUL, so callers must size each buffer
// at 256 bytes (the reference wrappers' convention) — an arbitrarily
// long CSV header can then never run past the caller's allocation.
constexpr size_t kMaxNameLen = 255;

int strings_out(PyObject* res, int* out_len, char** out_strs) {
  if (res == nullptr) return -1;
  Py_ssize_t n = PyList_Size(res);
  *out_len = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    const char* c = PyUnicode_AsUTF8(PyList_GetItem(res, i));
    if (c == nullptr) {
      set_error_from_python();
      Py_DECREF(res);
      return -1;
    }
    size_t len = std::strlen(c);
    if (len > kMaxNameLen) len = kMaxNameLen;
    std::memcpy(out_strs[i], c, len);
    out_strs[i][len] = '\0';
  }
  Py_DECREF(res);
  return 0;
}

uint64_t addr(const void* p) {
  return static_cast<uint64_t>(reinterpret_cast<uintptr_t>(p));
}

PyObject* none_or(void* handle) {
  // Borrowed Py_None / handle; Py_BuildValue "O" increfs as needed.
  return handle ? reinterpret_cast<PyObject*>(handle) : Py_None;
}

}  // namespace

extern "C" {

#define EXPORT __attribute__((visibility("default")))

EXPORT const char* LGBM_GetLastError() { return g_last_error.c_str(); }

// --- Dataset ----------------------------------------------------------------

EXPORT int LGBM_DatasetCreateFromFile(const char* filename,
                                      const char* parameters,
                                      void* reference, void** out) {
  Gil gil;
  return handle_out(call_shim("dataset_from_file", "(ssO)", filename,
                              parameters ? parameters : "",
                              none_or(reference)),
                    out);
}

EXPORT int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                                     int32_t nrow, int32_t ncol,
                                     int is_row_major, const char* parameters,
                                     void* reference, void** out) {
  Gil gil;
  return handle_out(
      call_shim("dataset_from_mat", "(KiiiisO)", addr(data), data_type,
                static_cast<int>(nrow), static_cast<int>(ncol), is_row_major,
                parameters ? parameters : "", none_or(reference)),
      out);
}

EXPORT int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                                     const int32_t* indices, const void* data,
                                     int data_type, int64_t nindptr,
                                     int64_t nelem, int64_t num_col,
                                     const char* parameters, void* reference,
                                     void** out) {
  Gil gil;
  return handle_out(
      call_shim("dataset_from_csr", "(KiKKiLLLsO)", addr(indptr), indptr_type,
                addr(indices), addr(data), data_type,
                static_cast<long long>(nindptr),
                static_cast<long long>(nelem),
                static_cast<long long>(num_col), parameters ? parameters : "",
                none_or(reference)),
      out);
}

EXPORT int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                                     const int32_t* indices, const void* data,
                                     int data_type, int64_t ncol_ptr,
                                     int64_t nelem, int64_t num_row,
                                     const char* parameters, void* reference,
                                     void** out) {
  Gil gil;
  return handle_out(
      call_shim("dataset_from_csc", "(KiKKiLLLsO)", addr(col_ptr),
                col_ptr_type, addr(indices), addr(data), data_type,
                static_cast<long long>(ncol_ptr),
                static_cast<long long>(nelem),
                static_cast<long long>(num_row), parameters ? parameters : "",
                none_or(reference)),
      out);
}

EXPORT int LGBM_DatasetCreateFromSampledColumn(
    double** sample_data, int** sample_indices, int32_t ncol,
    const int* num_per_col, int32_t num_sample_row, int32_t num_total_row,
    const char* parameters, void** out) {
  Gil gil;
  // column pointer arrays → python lists of addresses / counts
  PyObject* cols = PyList_New(ncol);
  PyObject* idxs = PyList_New(ncol);
  PyObject* cnts = PyList_New(ncol);
  if (!cols || !idxs || !cnts) {
    Py_XDECREF(cols);
    Py_XDECREF(idxs);
    Py_XDECREF(cnts);
    set_error_from_python();
    return -1;
  }
  for (int32_t j = 0; j < ncol; ++j) {
    PyList_SetItem(cols, j, PyLong_FromUnsignedLongLong(addr(sample_data[j])));
    PyList_SetItem(idxs, j, PyLong_FromUnsignedLongLong(
                                addr(sample_indices ? sample_indices[j]
                                                    : nullptr)));
    PyList_SetItem(cnts, j, PyLong_FromLong(num_per_col[j]));
  }
  PyObject* shim_mod = shim();
  if (shim_mod == nullptr) {
    Py_DECREF(cols);
    Py_DECREF(idxs);
    Py_DECREF(cnts);
    set_error_from_python();
    return -1;
  }
  PyObject* params = Py_BuildValue("s", parameters ? parameters : "");
  PyObject* pdict =
      call_shim("_params_from_string", "(O)", params);
  Py_XDECREF(params);
  if (pdict == nullptr) {
    Py_DECREF(cols);
    Py_DECREF(idxs);
    Py_DECREF(cnts);
    return -1;
  }
  PyObject* cls = PyObject_GetAttrString(shim_mod, "CApiDataset");
  PyObject* res = nullptr;
  if (cls != nullptr) {
    res = PyObject_CallMethod(cls, "from_sampled_column", "(OOOiiO)", cols,
                              idxs, cnts, static_cast<int>(num_sample_row),
                              static_cast<int>(num_total_row), pdict);
    Py_DECREF(cls);
  }
  Py_DECREF(cols);
  Py_DECREF(idxs);
  Py_DECREF(cnts);
  Py_DECREF(pdict);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  return handle_out(res, out);
}

EXPORT int LGBM_DatasetCreateByReference(void* reference,
                                         int64_t num_total_row, void** out) {
  Gil gil;
  PyObject* shim_mod = shim();
  if (shim_mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* cls = PyObject_GetAttrString(shim_mod, "CApiDataset");
  if (cls == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* res =
      PyObject_CallMethod(cls, "empty_like", "(OL)", none_or(reference),
                          static_cast<long long>(num_total_row));
  Py_DECREF(cls);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  return handle_out(res, out);
}

EXPORT int LGBM_DatasetPushRows(void* dataset, const void* data, int data_type,
                                int32_t nrow, int32_t ncol,
                                int32_t start_row) {
  Gil gil;
  return void_out(call_shim("dataset_push_rows", "(OKiiii)", none_or(dataset),
                            addr(data), data_type, static_cast<int>(nrow),
                            static_cast<int>(ncol),
                            static_cast<int>(start_row)));
}

EXPORT int LGBM_DatasetPushRowsByCSR(void* dataset, const void* indptr,
                                     int indptr_type, const int32_t* indices,
                                     const void* data, int data_type,
                                     int64_t nindptr, int64_t nelem,
                                     int64_t num_col, int64_t start_row) {
  Gil gil;
  return void_out(call_shim(
      "dataset_push_rows_csr", "(OKiKKiLLLL)", none_or(dataset), addr(indptr),
      indptr_type, addr(indices), addr(data), data_type,
      static_cast<long long>(nindptr), static_cast<long long>(nelem),
      static_cast<long long>(num_col), static_cast<long long>(start_row)));
}

EXPORT int LGBM_DatasetGetSubset(void* handle, const int32_t* used_row_indices,
                                 int32_t num_used_row_indices,
                                 const char* parameters, void** out) {
  Gil gil;
  return handle_out(
      call_shim("dataset_get_subset", "(OKis)", none_or(handle),
                addr(used_row_indices),
                static_cast<int>(num_used_row_indices),
                parameters ? parameters : ""),
      out);
}

EXPORT int LGBM_DatasetSetFeatureNames(void* handle,
                                       const char** feature_names,
                                       int num_feature_names) {
  Gil gil;
  PyObject* names = PyList_New(num_feature_names);
  if (names == nullptr) {
    set_error_from_python();
    return -1;
  }
  for (int i = 0; i < num_feature_names; ++i) {
    PyList_SetItem(names, i, PyUnicode_FromString(feature_names[i]));
  }
  PyObject* ds = reinterpret_cast<PyObject*>(handle);
  PyObject* inner = PyObject_GetAttrString(ds, "inner");
  int rc = -1;
  if (inner != nullptr) {
    rc = PyObject_SetAttrString(inner, "feature_names", names);
    Py_DECREF(inner);
  }
  Py_DECREF(names);
  if (rc != 0) set_error_from_python();
  return rc == 0 ? 0 : -1;
}

EXPORT int LGBM_DatasetGetFeatureNames(void* handle, char** feature_names,
                                       int* num_feature_names) {
  Gil gil;
  PyObject* ds = reinterpret_cast<PyObject*>(handle);
  PyObject* inner = PyObject_GetAttrString(ds, "inner");
  if (inner == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* names = PyObject_GetAttrString(inner, "feature_names");
  Py_DECREF(inner);
  return strings_out(names, num_feature_names, feature_names);
}

EXPORT int LGBM_DatasetFree(void* handle) {
  Gil gil;
  Py_XDECREF(reinterpret_cast<PyObject*>(handle));
  return 0;
}

EXPORT int LGBM_DatasetSaveBinary(void* handle, const char* filename) {
  Gil gil;
  PyObject* ds = reinterpret_cast<PyObject*>(handle);
  PyObject* inner = PyObject_GetAttrString(ds, "inner");
  if (inner == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* res = PyObject_CallMethod(inner, "save_binary", "(s)", filename);
  Py_DECREF(inner);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_DatasetSetField(void* handle, const char* field_name,
                                const void* field_data, int num_element,
                                int type) {
  Gil gil;
  return void_out(call_method(handle, "set_field", "(sKii)", field_name,
                              addr(field_data), num_element, type));
}

EXPORT int LGBM_DatasetGetField(void* handle, const char* field_name,
                                int* out_len, const void** out_ptr,
                                int* out_type) {
  Gil gil;
  PyObject* res = call_method(handle, "get_field", "(s)", field_name);
  if (res == nullptr) return -1;
  unsigned long long a = 0;
  int n = 0, code = 0;
  if (!PyArg_ParseTuple(res, "Kii", &a, &n, &code)) {
    set_error_from_python();
    Py_DECREF(res);
    return -1;
  }
  Py_DECREF(res);
  *out_ptr = reinterpret_cast<const void*>(static_cast<uintptr_t>(a));
  *out_len = n;
  *out_type = code;
  return 0;
}

EXPORT int LGBM_DatasetGetNumData(void* handle, int* out) {
  Gil gil;
  PyObject* ds = reinterpret_cast<PyObject*>(handle);
  PyObject* inner = PyObject_GetAttrString(ds, "inner");
  if (inner == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* n = PyObject_GetAttrString(inner, "num_data");
  Py_DECREF(inner);
  return int_out(n, out);
}

EXPORT int LGBM_DatasetGetNumFeature(void* handle, int* out) {
  Gil gil;
  PyObject* ds = reinterpret_cast<PyObject*>(handle);
  PyObject* inner = PyObject_GetAttrString(ds, "inner");
  if (inner == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* n = PyObject_GetAttrString(inner, "num_total_features");
  Py_DECREF(inner);
  return int_out(n, out);
}

// --- Booster ----------------------------------------------------------------

EXPORT int LGBM_BoosterCreate(void* train_data, const char* parameters,
                              void** out) {
  Gil gil;
  PyObject* shim_mod = shim();
  if (shim_mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* cls = PyObject_GetAttrString(shim_mod, "CApiBooster");
  if (cls == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* res = PyObject_CallMethod(cls, "create", "(Os)",
                                      none_or(train_data),
                                      parameters ? parameters : "");
  Py_DECREF(cls);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  return handle_out(res, out);
}

static int booster_from(const char* classmethod, const char* arg,
                        int* out_num_iterations, void** out) {
  PyObject* shim_mod = shim();
  if (shim_mod == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* cls = PyObject_GetAttrString(shim_mod, "CApiBooster");
  if (cls == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* res = PyObject_CallMethod(cls, classmethod, "(s)", arg);
  Py_DECREF(cls);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  if (out_num_iterations != nullptr) {
    PyObject* b = PyObject_GetAttrString(res, "booster");
    int rc = -1;
    if (b != nullptr) {
      PyObject* n = PyObject_CallMethod(b, "current_iteration", nullptr);
      Py_DECREF(b);
      rc = int_out(n, out_num_iterations);
    } else {
      set_error_from_python();
    }
    if (rc != 0) {
      Py_DECREF(res);
      return -1;
    }
  }
  return handle_out(res, out);
}

EXPORT int LGBM_BoosterCreateFromModelfile(const char* filename,
                                           int* out_num_iterations,
                                           void** out) {
  Gil gil;
  return booster_from("from_model_file", filename, out_num_iterations, out);
}

EXPORT int LGBM_BoosterLoadModelFromString(const char* model_str,
                                           int* out_num_iterations,
                                           void** out) {
  Gil gil;
  return booster_from("from_model_string", model_str, out_num_iterations, out);
}

EXPORT int LGBM_BoosterFree(void* handle) {
  Gil gil;
  Py_XDECREF(reinterpret_cast<PyObject*>(handle));
  return 0;
}

EXPORT int LGBM_BoosterMerge(void* handle, void* other_handle) {
  Gil gil;
  return void_out(call_method(handle, "merge", "(O)",
                              none_or(other_handle)));
}

EXPORT int LGBM_BoosterAddValidData(void* handle, void* valid_data) {
  Gil gil;
  return void_out(call_method(handle, "add_valid", "(O)",
                              none_or(valid_data)));
}

EXPORT int LGBM_BoosterResetTrainingData(void* handle, void* train_data) {
  Gil gil;
  return void_out(call_method(handle, "reset_training_data", "(O)",
                              none_or(train_data)));
}

EXPORT int LGBM_BoosterResetParameter(void* handle, const char* parameters) {
  Gil gil;
  PyObject* pdict = call_shim("_params_from_string", "(s)",
                              parameters ? parameters : "");
  if (pdict == nullptr) return -1;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  int rc = -1;
  if (b != nullptr) {
    PyObject* res = PyObject_CallMethod(b, "reset_parameter", "(O)", pdict);
    if (res != nullptr) {
      rc = 0;
      Py_DECREF(res);
    } else {
      set_error_from_python();
    }
    Py_DECREF(b);
  } else {
    set_error_from_python();
  }
  Py_DECREF(pdict);
  return rc;
}

static int booster_int_attr(void* handle, const char* expr, int* out_len) {
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* g = PyObject_GetAttrString(b, "_gbdt");
  Py_DECREF(b);
  if (g == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* v = PyObject_GetAttrString(g, expr);
  Py_DECREF(g);
  return int_out(v, out_len);
}

EXPORT int LGBM_BoosterGetNumClasses(void* handle, int* out_len) {
  Gil gil;
  return booster_int_attr(handle, "num_class", out_len);
}

EXPORT int LGBM_BoosterUpdateOneIter(void* handle, int* is_finished) {
  Gil gil;
  PyObject* res = call_method(handle, "update", "");
  if (res == nullptr) return -1;
  *is_finished = PyObject_IsTrue(res) ? 1 : 0;
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterUpdateOneIterCustom(void* handle, const float* grad,
                                           const float* hess,
                                           int* is_finished) {
  Gil gil;
  PyObject* res = call_method(handle, "update_custom", "(KK)", addr(grad),
                              addr(hess));
  if (res == nullptr) return -1;
  *is_finished = PyObject_IsTrue(res) ? 1 : 0;
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterRefit(void* handle, const int* leaf_preds, int nrow,
                             int ncol) {
  Gil gil;
  return void_out(
      call_method(handle, "refit", "(Kii)", addr(leaf_preds), nrow, ncol));
}

EXPORT int LGBM_BoosterRollbackOneIter(void* handle) {
  Gil gil;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* res = PyObject_CallMethod(b, "rollback_one_iter", nullptr);
  Py_DECREF(b);
  if (res == nullptr) {
    set_error_from_python();
    return -1;
  }
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterGetCurrentIteration(void* handle, int* out_iteration) {
  Gil gil;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* n = PyObject_CallMethod(b, "current_iteration", nullptr);
  Py_DECREF(b);
  return int_out(n, out_iteration);
}

EXPORT int LGBM_BoosterGetEvalCounts(void* handle, int* out_len) {
  Gil gil;
  PyObject* res = call_method(handle, "eval_names", "");
  if (res == nullptr) return -1;
  *out_len = static_cast<int>(PyList_Size(res));
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterGetEvalNames(void* handle, int* out_len,
                                    char** out_strs) {
  Gil gil;
  return strings_out(call_method(handle, "eval_names", ""), out_len,
                     out_strs);
}

EXPORT int LGBM_BoosterGetFeatureNames(void* handle, int* out_len,
                                       char** out_strs) {
  Gil gil;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* names = PyObject_CallMethod(b, "feature_name", nullptr);
  Py_DECREF(b);
  if (names == nullptr) {
    set_error_from_python();
    return -1;
  }
  return strings_out(names, out_len, out_strs);
}

EXPORT int LGBM_BoosterGetNumFeature(void* handle, int* out_len) {
  Gil gil;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* n = PyObject_CallMethod(b, "num_feature", nullptr);
  Py_DECREF(b);
  return int_out(n, out_len);
}

EXPORT int LGBM_BoosterGetEval(void* handle, int data_idx, int* out_len,
                               double* out_results) {
  Gil gil;
  PyObject* res = call_method(handle, "get_eval", "(i)", data_idx);
  if (res == nullptr) return -1;
  Py_ssize_t n = PyList_Size(res);
  *out_len = static_cast<int>(n);
  for (Py_ssize_t i = 0; i < n; ++i) {
    out_results[i] = PyFloat_AsDouble(PyList_GetItem(res, i));
  }
  Py_DECREF(res);
  return 0;
}

static int inner_predict(void* handle, int data_idx, int64_t* out_len,
                         double* out_result) {
  PyObject* res = call_method(handle, "inner_predict", "(i)", data_idx);
  if (res == nullptr) return -1;
  // numpy float64 array: read its address + size via the array interface
  PyObject* size_o = PyObject_GetAttrString(res, "size");
  PyObject* ctypes_o = PyObject_GetAttrString(res, "ctypes");
  int rc = -1;
  if (size_o != nullptr && ctypes_o != nullptr) {
    PyObject* data_o = PyObject_GetAttrString(ctypes_o, "data");
    if (data_o != nullptr) {
      int64_t n = PyLong_AsLongLong(size_o);
      uintptr_t a =
          static_cast<uintptr_t>(PyLong_AsUnsignedLongLong(data_o));
      *out_len = n;
      if (out_result != nullptr) {
        std::memcpy(out_result, reinterpret_cast<const void*>(a),
                    static_cast<size_t>(n) * sizeof(double));
      }
      rc = 0;
      Py_DECREF(data_o);
    }
  }
  if (rc != 0) set_error_from_python();
  Py_XDECREF(size_o);
  Py_XDECREF(ctypes_o);
  Py_DECREF(res);
  return rc;
}

EXPORT int LGBM_BoosterGetNumPredict(void* handle, int data_idx,
                                     int64_t* out_len) {
  Gil gil;
  // pure size query — must not materialize the prediction array
  PyObject* res = call_method(handle, "inner_predict_len", "(i)", data_idx);
  if (res == nullptr) return -1;
  *out_len = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterGetPredict(void* handle, int data_idx,
                                  int64_t* out_len, double* out_result) {
  Gil gil;
  return inner_predict(handle, data_idx, out_len, out_result);
}

EXPORT int LGBM_BoosterPredictForFile(void* handle, const char* data_filename,
                                      int data_has_header, int predict_type,
                                      int num_iteration,
                                      const char* result_filename) {
  Gil gil;
  return void_out(call_method(handle, "predict_for_file", "(siiis)",
                              data_filename, data_has_header, predict_type,
                              num_iteration, result_filename));
}

EXPORT int LGBM_BoosterCalcNumPredict(void* handle, int num_row,
                                      int predict_type, int num_iteration,
                                      int64_t* out_len) {
  Gil gil;
  PyObject* res = call_method(handle, "calc_num_predict", "(iii)", num_row,
                              predict_type, num_iteration);
  if (res == nullptr) return -1;
  *out_len = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterPredictForMat(void* handle, const void* data,
                                     int data_type, int32_t nrow, int32_t ncol,
                                     int is_row_major, int predict_type,
                                     int num_iteration, int64_t* out_len,
                                     double* out_result) {
  Gil gil;
  PyObject* res = call_method(
      handle, "predict_for_mat", "(KiiiiiiK)", addr(data), data_type,
      static_cast<int>(nrow), static_cast<int>(ncol), is_row_major,
      predict_type, num_iteration, addr(out_result));
  if (res == nullptr) return -1;
  *out_len = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterPredictForCSR(void* handle, const void* indptr,
                                     int indptr_type, const int32_t* indices,
                                     const void* data, int data_type,
                                     int64_t nindptr, int64_t nelem,
                                     int64_t num_col, int predict_type,
                                     int num_iteration, int64_t* out_len,
                                     double* out_result) {
  Gil gil;
  PyObject* res = call_method(
      handle, "predict_for_csr", "(KiKKiLLLiiK)", addr(indptr), indptr_type,
      addr(indices), addr(data), data_type, static_cast<long long>(nindptr),
      static_cast<long long>(nelem), static_cast<long long>(num_col),
      predict_type, num_iteration, addr(out_result));
  if (res == nullptr) return -1;
  *out_len = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterPredictForCSC(void* handle, const void* col_ptr,
                                     int col_ptr_type, const int32_t* indices,
                                     const void* data, int data_type,
                                     int64_t ncol_ptr, int64_t nelem,
                                     int64_t num_row, int predict_type,
                                     int num_iteration, int64_t* out_len,
                                     double* out_result) {
  Gil gil;
  PyObject* res = call_method(
      handle, "predict_for_csc", "(KiKKiLLLiiK)", addr(col_ptr), col_ptr_type,
      addr(indices), addr(data), data_type, static_cast<long long>(ncol_ptr),
      static_cast<long long>(nelem), static_cast<long long>(num_row),
      predict_type, num_iteration, addr(out_result));
  if (res == nullptr) return -1;
  *out_len = PyLong_AsLongLong(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterSaveModel(void* handle, int num_iteration,
                                 const char* filename) {
  Gil gil;
  return void_out(call_method(handle, "save_model", "(is)", num_iteration,
                              filename));
}

EXPORT int LGBM_BoosterSaveModelToString(void* handle, int num_iteration,
                                         int buffer_len, int* out_len,
                                         char* out_str) {
  Gil gil;
  return string_out(call_method(handle, "model_to_string", "(i)",
                                num_iteration),
                    buffer_len, out_len, out_str);
}

EXPORT int LGBM_BoosterDumpModel(void* handle, int num_iteration,
                                 int buffer_len, int* out_len,
                                 char* out_str) {
  Gil gil;
  return string_out(call_method(handle, "dump_model", "(i)", num_iteration),
                    buffer_len, out_len, out_str);
}

EXPORT int LGBM_BoosterGetLeafValue(void* handle, int tree_idx, int leaf_idx,
                                    double* out_val) {
  Gil gil;
  PyObject* res = call_method(handle, "get_leaf_value", "(ii)", tree_idx,
                              leaf_idx);
  if (res == nullptr) return -1;
  *out_val = PyFloat_AsDouble(res);
  Py_DECREF(res);
  return 0;
}

EXPORT int LGBM_BoosterSetLeafValue(void* handle, int tree_idx, int leaf_idx,
                                    double val) {
  Gil gil;
  return void_out(call_method(handle, "set_leaf_value", "(iid)", tree_idx,
                              leaf_idx, val));
}

EXPORT int LGBM_BoosterNumberOfTotalModel(void* handle, int* out_models) {
  Gil gil;
  PyObject* b = PyObject_GetAttrString(reinterpret_cast<PyObject*>(handle),
                                       "booster");
  if (b == nullptr) {
    set_error_from_python();
    return -1;
  }
  PyObject* n = PyObject_CallMethod(b, "num_trees", nullptr);
  Py_DECREF(b);
  return int_out(n, out_models);
}

}  // extern "C"
