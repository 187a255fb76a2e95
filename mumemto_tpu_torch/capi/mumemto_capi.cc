// libmumemto_tpu_torch.so — C ABI over the PyTorch match-finding engine.
//
// A copy of native/mumemto_capi.cc whose engine is the Python module
// mumemto_tpu_torch.library, hosted in an embedded CPython interpreter; the
// interface is native/mumemto_tpu.h, unchanged, so a C consumer of the JAX
// package's library links against this one as it is. Results are copied out
// of Python into plain C arrays at call time, so the returned views have no
// lifetime ties to the interpreter state.
//
// The device: the C entry points pass positional arguments only, so the
// Python shims (_cabi_mum, _cabi_mem) read the process-wide default from the
// environment variable MUMEMTO_TORCH_DEVICE ("cuda" when unset, "cpu" to run
// on torch-CPU). There is no fallback: "cuda" without a card fails, and the
// error text is what mumemto_tpu_last_error() returns.
//
// Built by mumemto_tpu_torch/capi/build_capi.py:
// g++ -O3 -shared -fPIC -lpython3.x.

#include "mumemto_tpu.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;
std::string g_module_path;

void set_error(const std::string& msg) { g_last_error = msg; }

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) msg = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  set_error(msg);
}

// One-time interpreter bring-up; afterwards every entry point uses
// PyGILState_Ensure/Release so any thread may call in.
bool ensure_python() {
  static bool initialized = false;
  if (initialized) return true;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    if (!Py_IsInitialized()) {
      set_error("failed to initialize embedded Python");
      return false;
    }
    // Release the GIL acquired by initialization; entry points re-acquire.
    PyEval_SaveThread();
  }
  initialized = true;
  return true;
}

// Runs inside a held GIL. Returns borrowed-free new ref or nullptr.
PyObject* import_library() {
  const char* env = std::getenv("MUMEMTO_TPU_PYROOT");
  const std::string& extra =
      !g_module_path.empty() ? g_module_path : (env ? env : "");
  if (!extra.empty()) {
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    if (sys_path != nullptr) {
      PyObject* p = PyUnicode_FromString(extra.c_str());
      if (p != nullptr) {
        if (!PySequence_Contains(sys_path, p)) PyList_Insert(sys_path, 0, p);
        Py_DECREF(p);
      }
    }
  }
  const char* prelude = std::getenv("MUMEMTO_TPU_CABI_PRELUDE");
  if (prelude != nullptr && *prelude) PyRun_SimpleString(prelude);
  return PyImport_ImportModule("mumemto_tpu_torch.library");
}

PyObject* docs_to_pylist(const mumemto_tpu_doc* docs, size_t num_docs) {
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(num_docs));
  if (out == nullptr) return nullptr;
  for (size_t d = 0; d < num_docs; ++d) {
    PyObject* rec = PyList_New(static_cast<Py_ssize_t>(docs[d].num_seqs));
    if (rec == nullptr) { Py_DECREF(out); return nullptr; }
    for (size_t s = 0; s < docs[d].num_seqs; ++s) {
      PyObject* b = PyBytes_FromString(docs[d].seqs[s]);
      if (b == nullptr) { Py_DECREF(rec); Py_DECREF(out); return nullptr; }
      PyList_SET_ITEM(rec, static_cast<Py_ssize_t>(s), b);
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(d), rec);
  }
  return out;
}

bool copy_bytes(PyObject* tuple, Py_ssize_t idx, std::vector<char>* out) {
  PyObject* b = PyTuple_GetItem(tuple, idx);  // borrowed
  if (b == nullptr) return false;
  char* buf = nullptr;
  Py_ssize_t len = 0;
  if (PyBytes_AsStringAndSize(b, &buf, &len) != 0) return false;
  out->assign(buf, buf + len);
  return true;
}

}  // namespace

struct mumemto_tpu_result {
  int is_mem = 0;
  size_t num_matches = 0;
  size_t num_docs = 0;
  std::vector<char> lengths;   // u32[num_matches]
  std::vector<char> offsets;   // mum: i64[num_matches*num_docs]
  std::vector<char> strands;   // mum: u8 [num_matches*num_docs]; mem: per occ
  std::vector<char> occ_off;   // mem: u64[num_matches+1]
  std::vector<char> positions; // mem: i64[total_occ]
  std::vector<char> seq_ids;   // mem: u32[total_occ]

  uint64_t occ_start(size_t i) const {
    return reinterpret_cast<const uint64_t*>(occ_off.data())[i];
  }
};

extern "C" {

void mumemto_tpu_set_module_path(const char* path) {
  g_module_path = path ? path : "";
}

const char* mumemto_tpu_last_error(void) { return g_last_error.c_str(); }

static mumemto_tpu_result* run_call(const char* fn_name,
                                    const mumemto_tpu_doc* docs,
                                    size_t num_docs, PyObject* extra_args,
                                    int is_mem) {
  // extra_args: new ref tuple of scalar args after the docs list; stolen.
  if (!ensure_python()) { Py_XDECREF(extra_args); return nullptr; }
  PyGILState_STATE gil = PyGILState_Ensure();
  mumemto_tpu_result* res = nullptr;
  PyObject* mod = nullptr;
  PyObject* fn = nullptr;
  PyObject* pydocs = nullptr;
  PyObject* args = nullptr;
  PyObject* out = nullptr;
  do {
    mod = import_library();
    if (mod == nullptr) { set_error_from_python(); break; }
    fn = PyObject_GetAttrString(mod, fn_name);
    if (fn == nullptr) { set_error_from_python(); break; }
    pydocs = docs_to_pylist(docs, num_docs);
    if (pydocs == nullptr) { set_error_from_python(); break; }
    Py_ssize_t extra = PyTuple_GET_SIZE(extra_args);
    args = PyTuple_New(1 + extra);
    if (args == nullptr) { set_error_from_python(); break; }
    PyTuple_SET_ITEM(args, 0, pydocs);
    pydocs = nullptr;  // stolen
    for (Py_ssize_t i = 0; i < extra; ++i) {
      PyObject* item = PyTuple_GET_ITEM(extra_args, i);
      Py_INCREF(item);
      PyTuple_SET_ITEM(args, 1 + i, item);
    }
    out = PyObject_CallObject(fn, args);
    if (out == nullptr) { set_error_from_python(); break; }

    res = new mumemto_tpu_result();
    res->is_mem = is_mem;
    res->num_matches =
        static_cast<size_t>(PyLong_AsSsize_t(PyTuple_GetItem(out, 0)));
    res->num_docs =
        static_cast<size_t>(PyLong_AsSsize_t(PyTuple_GetItem(out, 1)));
    bool ok;
    if (is_mem) {
      ok = copy_bytes(out, 2, &res->lengths) &&
           copy_bytes(out, 3, &res->occ_off) &&
           copy_bytes(out, 4, &res->positions) &&
           copy_bytes(out, 5, &res->seq_ids) &&
           copy_bytes(out, 6, &res->strands);
    } else {
      ok = copy_bytes(out, 2, &res->lengths) &&
           copy_bytes(out, 3, &res->offsets) &&
           copy_bytes(out, 4, &res->strands);
    }
    if (!ok || PyErr_Occurred()) {
      set_error_from_python();
      delete res;
      res = nullptr;
    }
  } while (false);
  Py_XDECREF(out);
  Py_XDECREF(args);
  Py_XDECREF(pydocs);
  Py_XDECREF(fn);
  Py_XDECREF(mod);
  Py_XDECREF(extra_args);
  PyGILState_Release(gil);
  return res;
}

mumemto_tpu_result* mumemto_tpu_mum(const mumemto_tpu_doc* docs,
                                    size_t num_docs, uint32_t min_match_len,
                                    int use_revcomp, int64_t num_distinct) {
  if (docs == nullptr || num_docs == 0) {
    set_error("no documents given");
    return nullptr;
  }
  if (!ensure_python()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* extra = Py_BuildValue("(IiL)", min_match_len, use_revcomp,
                                  static_cast<long long>(num_distinct));
  PyGILState_Release(gil);
  if (extra == nullptr) { set_error("argument marshalling failed"); return nullptr; }
  return run_call("_cabi_mum", docs, num_docs, extra, /*is_mem=*/0);
}

mumemto_tpu_result* mumemto_tpu_mem(const mumemto_tpu_doc* docs,
                                    size_t num_docs, uint32_t min_match_len,
                                    int use_revcomp, int64_t num_distinct,
                                    int64_t max_total_freq,
                                    int64_t max_doc_freq) {
  if (docs == nullptr || num_docs == 0) {
    set_error("no documents given");
    return nullptr;
  }
  if (!ensure_python()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* extra =
      Py_BuildValue("(IiLLL)", min_match_len, use_revcomp,
                    static_cast<long long>(num_distinct),
                    static_cast<long long>(max_total_freq),
                    static_cast<long long>(max_doc_freq));
  PyGILState_Release(gil);
  if (extra == nullptr) { set_error("argument marshalling failed"); return nullptr; }
  return run_call("_cabi_mem", docs, num_docs, extra, /*is_mem=*/1);
}

size_t mumemto_tpu_num_matches(const mumemto_tpu_result* r) {
  return r ? r->num_matches : 0;
}

size_t mumemto_tpu_num_docs(const mumemto_tpu_result* r) {
  return r ? r->num_docs : 0;
}

uint32_t mumemto_tpu_match_length(const mumemto_tpu_result* r, size_t i) {
  if (r == nullptr || i >= r->num_matches) return 0;
  return reinterpret_cast<const uint32_t*>(r->lengths.data())[i];
}

const int64_t* mumemto_tpu_match_offsets(const mumemto_tpu_result* r,
                                         size_t i) {
  if (r == nullptr || r->is_mem || i >= r->num_matches) return nullptr;
  return reinterpret_cast<const int64_t*>(r->offsets.data()) +
         i * r->num_docs;
}

const uint8_t* mumemto_tpu_match_strands(const mumemto_tpu_result* r,
                                         size_t i) {
  if (r == nullptr || r->is_mem || i >= r->num_matches) return nullptr;
  return reinterpret_cast<const uint8_t*>(r->strands.data()) +
         i * r->num_docs;
}

size_t mumemto_tpu_match_num_occ(const mumemto_tpu_result* r, size_t i) {
  if (r == nullptr || !r->is_mem || i >= r->num_matches) return 0;
  return static_cast<size_t>(r->occ_start(i + 1) - r->occ_start(i));
}

const int64_t* mumemto_tpu_match_positions(const mumemto_tpu_result* r,
                                           size_t i) {
  if (r == nullptr || !r->is_mem || i >= r->num_matches) return nullptr;
  return reinterpret_cast<const int64_t*>(r->positions.data()) +
         r->occ_start(i);
}

const uint32_t* mumemto_tpu_match_seq_ids(const mumemto_tpu_result* r,
                                          size_t i) {
  if (r == nullptr || !r->is_mem || i >= r->num_matches) return nullptr;
  return reinterpret_cast<const uint32_t*>(r->seq_ids.data()) +
         r->occ_start(i);
}

const uint8_t* mumemto_tpu_match_occ_strands(const mumemto_tpu_result* r,
                                             size_t i) {
  if (r == nullptr || !r->is_mem || i >= r->num_matches) return nullptr;
  return reinterpret_cast<const uint8_t*>(r->strands.data()) +
         r->occ_start(i);
}

void mumemto_tpu_free(mumemto_tpu_result* r) { delete r; }

}  // extern "C"
