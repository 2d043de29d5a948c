// pathway_torch_native — C++ host-runtime hot paths for pathway_tpu_torch.
//
// The reference implements its engine hot loops in Rust
// (src/engine/value.rs Key hashing, src/connectors tokenization); the
// TPU build keeps the numeric plane in XLA and implements the host-side
// hot paths here as a CPython extension:
//
//   - ref_scalar(args_tuple) / hash_rows(list[tuple]): 128-bit row-key
//     hashing, byte-for-byte identical to the Python implementation in
//     pathway_tpu/internals/keys.py (type-tagged serialization into
//     BLAKE2b-128) — keys are stable across the two paths, which
//     persistence snapshots rely on.
//   - scan_lines(bytes): newline scanning for the file data loader.
//   - consolidate(batch, update_cls, hashable_row): merge update deltas
//     with equal (key, row) — the per-node compaction the reference runs
//     inside differential arrangements (src/engine/dataflow.rs
//     consolidation); single-occurrence updates are re-emitted by
//     reference (no allocation).
//   - per_key_changes(batch): group a batch into per-key (removals,
//     additions) lists.
//   - coerce_rows(rows, plan): bulk schema coercion of parsed row dicts
//     into value tuples (reference parser hot loop,
//     src/connectors/data_format.rs DsvParser/JsonLinesParser).
//   - build_adds(rows, update_cls): bulk Update(key, values, +1)
//     construction for chunked connector ingest.
//
// Unsupported value types (big ints, ndarrays, datetimes, arbitrary
// objects) raise _Unsupported so the caller transparently falls back to
// the Python path for that call.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <datetime.h>

#include <algorithm>
#include <atomic>
#include <cctype>
#include <chrono>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <unordered_map>
#include <vector>

#include "blake2b.h"

namespace {

PyObject* g_unsupported = nullptr;  // exception type for fallback
PyObject* g_pointer_type = nullptr;  // pathway_tpu_torch Pointer class

// ---------------------------------------------------------------------------
// CPython 3.13 removed _PyLong_NumBits / _PyLong_AsByteArray /
// _PyLong_FromByteArray from the public headers (and changed the
// _PyLong_AsByteArray signature), which would make this whole extension
// silently fail to compile and every fast path degrade to Python.  Wrap
// the int<->bytes conversions so 3.13+ uses the new stable
// PyLong_AsNativeBytes / PyLong_FromNativeBytes API instead.
// All helpers return 0 / non-NULL on success; on failure the caller is
// expected to PyErr_Clear() and fall back.
#if PY_VERSION_HEX >= 0x030D0000
inline int pt_long_as_bytes_unsigned(PyObject* v, uint8_t* out, size_t n) {
    Py_ssize_t r = PyLong_AsNativeBytes(
        v, out, (Py_ssize_t)n,
        Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER |
            Py_ASNATIVEBYTES_REJECT_NEGATIVE);
    return (r < 0 || (size_t)r > n) ? -1 : 0;
}
inline int pt_long_as_bytes_signed(PyObject* v, uint8_t* out, size_t n) {
    // sign-extends into the full n-byte buffer, matching
    // int.to_bytes(n, "little", signed=True)
    Py_ssize_t r = PyLong_AsNativeBytes(v, out, (Py_ssize_t)n,
                                        Py_ASNATIVEBYTES_LITTLE_ENDIAN);
    return (r < 0 || (size_t)r > n) ? -1 : 0;
}
inline size_t pt_long_numbits(PyObject* v) {
    // no public C equivalent of _PyLong_NumBits; the object-protocol call
    // is acceptable because this only runs on the rare >64-bit path
    PyObject* bl = PyObject_CallMethod(v, "bit_length", nullptr);
    if (bl == nullptr) return (size_t)-1;
    size_t bits = PyLong_AsSize_t(bl);
    Py_DECREF(bl);
    if (bits == (size_t)-1 && PyErr_Occurred()) return (size_t)-1;
    return bits;
}
inline PyObject* pt_long_from_bytes_unsigned(const uint8_t* buf, size_t n) {
    return PyLong_FromNativeBytes(
        buf, (Py_ssize_t)n,
        Py_ASNATIVEBYTES_LITTLE_ENDIAN | Py_ASNATIVEBYTES_UNSIGNED_BUFFER);
}
#else
inline int pt_long_as_bytes_unsigned(PyObject* v, uint8_t* out, size_t n) {
    return _PyLong_AsByteArray(reinterpret_cast<PyLongObject*>(v), out, n,
                               /*little_endian=*/1, /*is_signed=*/0);
}
inline int pt_long_as_bytes_signed(PyObject* v, uint8_t* out, size_t n) {
    return _PyLong_AsByteArray(reinterpret_cast<PyLongObject*>(v), out, n,
                               /*little_endian=*/1, /*is_signed=*/1);
}
inline size_t pt_long_numbits(PyObject* v) { return _PyLong_NumBits(v); }
inline PyObject* pt_long_from_bytes_unsigned(const uint8_t* buf, size_t n) {
    return _PyLong_FromByteArray(buf, n, /*little_endian=*/1, /*signed=*/0);
}
#endif

const char kSalt[] = "pathway_tpu.key.v1";

struct Hasher {
    pwnative::Blake2bState S;
    Hasher() {
        pwnative::blake2b_init(&S, 16);
        pwnative::blake2b_update(
            &S, reinterpret_cast<const uint8_t*>(kSalt), sizeof(kSalt) - 1);
    }
    void bytes(const void* p, size_t n) {
        pwnative::blake2b_update(&S, static_cast<const uint8_t*>(p), n);
    }
    void tag(uint8_t t) { bytes(&t, 1); }
    void u64le(uint64_t v) { bytes(&v, 8); }
};

// collects the exact byte stream ``feed`` would hash — used as the memo
// key for route_split's per-row digest cache
struct ByteSink {
    std::string& out;
    void bytes(const void* p, size_t n) {
        out.append(static_cast<const char*>(p), n);
    }
    void tag(uint8_t t) { out.push_back(static_cast<char>(t)); }
    void u64le(uint64_t v) {
        out.append(reinterpret_cast<const char*>(&v), 8);
    }
};

// mirror of keys._feed — must stay byte-identical.  Templated over the
// sink so route_split can serialize the fed bytes once (ByteSink) while
// key hashing keeps streaming straight into BLAKE2b (Hasher).
template <typename Sink>
bool feed(Sink& h, PyObject* v) {
    if (v == Py_None) {
        h.tag(0x00);
        return true;
    }
    if (PyBool_Check(v)) {
        h.tag(0x01);
        h.tag(v == Py_True ? 0x01 : 0x00);
        return true;
    }
    if (g_pointer_type != nullptr &&
        PyObject_TypeCheck(v, reinterpret_cast<PyTypeObject*>(g_pointer_type))) {
        uint8_t out[16];
        if (pt_long_as_bytes_unsigned(v, out, 16) < 0) {
            PyErr_Clear();
            return false;  // >128-bit pointer: fall back
        }
        h.tag(0x07);
        h.bytes(out, 16);
        return true;
    }
    if (PyLong_Check(v)) {
        int overflow = 0;
        long long val = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (overflow != 0) {
            // big int (e.g. 128-bit join/derive key material): replicate
            // value.to_bytes((bit_length + 8)//8 + 1, "little", signed)
            size_t bits = pt_long_numbits(v);
            if (bits == (size_t)-1) {
                PyErr_Clear();
                return false;
            }
            size_t nb = (bits + 8) / 8 + 1;
            uint8_t buf[64];
            if (nb > sizeof(buf)) return false;  // >~500 bits: fall back
            if (pt_long_as_bytes_signed(v, buf, nb) < 0) {
                PyErr_Clear();
                return false;
            }
            h.tag(0x02);
            h.bytes(buf, nb);
            return true;
        }
        // python: n = (bit_length + 8) // 8 + 1 bytes, signed little
        unsigned long long mag =
            val < 0 ? (unsigned long long)(-(val + 1)) + 1ULL
                    : (unsigned long long)val;
        // bit_length (0 for val==0); `mag >> bl` would be UB at bl==64
        // (mag == 2^63 when val == INT64_MIN), so use clz instead.
        int bl = mag ? 64 - __builtin_clzll(mag) : 0;
        int n = (bl + 8) / 8 + 1;
        uint8_t buf[16];
        long long x = val;
        for (int i = 0; i < n; i++) {
            buf[i] = (uint8_t)(x & 0xff);
            x >>= 8;  // arithmetic shift: sign-extends
        }
        h.tag(0x02);
        h.bytes(buf, n);
        return true;
    }
    if (PyFloat_Check(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        h.tag(0x03);
        h.bytes(&d, 8);
        return true;
    }
    if (PyUnicode_Check(v)) {
        Py_ssize_t n;
        const char* s = PyUnicode_AsUTF8AndSize(v, &n);
        if (s == nullptr) return false;
        h.tag(0x04);
        h.u64le((uint64_t)n);
        h.bytes(s, (size_t)n);
        return true;
    }
    if (PyBytes_Check(v)) {
        h.tag(0x05);
        h.u64le((uint64_t)PyBytes_GET_SIZE(v));
        h.bytes(PyBytes_AS_STRING(v), (size_t)PyBytes_GET_SIZE(v));
        return true;
    }
    if (PyTuple_Check(v)) {
        Py_ssize_t n = PyTuple_GET_SIZE(v);
        h.tag(0x06);
        h.u64le((uint64_t)n);
        for (Py_ssize_t i = 0; i < n; i++) {
            if (!feed(h, PyTuple_GET_ITEM(v, i))) return false;
        }
        return true;
    }
    return false;  // datetime / ndarray / other: fall back
}

PyObject* digest_to_long(Hasher& h) {
    uint8_t out[16];
    pwnative::blake2b_final(&h.S, out);
    return pt_long_from_bytes_unsigned(out, 16);
}

// Pointer construction is a per-row cost in every hot loop (key hashing,
// frame unpack), and calling the class pays the full type-call protocol
// — comparable to parsing the whole row.  Pointer is a bare int subclass
// (``__slots__ = ()``), so pre-3.12, where the PyLongObject layout is
// public, clone the digits into a tp_alloc'd instance exactly as
// CPython's long_subtype_new does.  The guards drop back to the call
// protocol if Pointer ever grows a custom __new__/__init__ or storage
// (and on 3.12+, where the int layout went opaque).  Steals ``num``.
PyObject* pointer_from_long(PyObject* num) {
    if (num == nullptr || g_pointer_type == nullptr) return num;
    PyTypeObject* pt = reinterpret_cast<PyTypeObject*>(g_pointer_type);
#if PY_VERSION_HEX < 0x030C0000
    if (pt->tp_new == PyLong_Type.tp_new &&
        pt->tp_init == PyLong_Type.tp_init &&
        pt->tp_basicsize == PyLong_Type.tp_basicsize &&
        pt->tp_itemsize == PyLong_Type.tp_itemsize &&
        PyLong_CheckExact(num)) {
        Py_ssize_t sz = Py_SIZE(num);
        Py_ssize_t ndig = sz < 0 ? -sz : sz;
        PyLongObject* p =
            reinterpret_cast<PyLongObject*>(pt->tp_alloc(pt, ndig));
        if (p == nullptr) {
            Py_DECREF(num);
            return nullptr;
        }
        Py_SET_SIZE(p, sz);
        PyLongObject* src = reinterpret_cast<PyLongObject*>(num);
        for (Py_ssize_t i = 0; i < ndig; i++)
            p->ob_digit[i] = src->ob_digit[i];
        Py_DECREF(num);
        return reinterpret_cast<PyObject*>(p);
    }
#endif
    PyObject* ptr = PyObject_CallFunctionObjArgs(g_pointer_type, num, nullptr);
    Py_DECREF(num);
    return ptr;
}

PyObject* py_ref_scalar(PyObject*, PyObject* args_tuple) {
    Hasher h;
    Py_ssize_t n = PyTuple_GET_SIZE(args_tuple);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!feed(h, PyTuple_GET_ITEM(args_tuple, i))) {
            if (!PyErr_Occurred())
                PyErr_SetString(g_unsupported, "unsupported value type");
            return nullptr;
        }
    }
    return digest_to_long(h);
}

PyObject* py_hash_rows(PyObject*, PyObject* rows) {
    // rows: sequence of tuples -> list of 128-bit ints
    PyObject* seq = PySequence_Fast(rows, "hash_rows expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* row = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(row)) {
            Py_DECREF(seq);
            Py_DECREF(out);
            PyErr_SetString(PyExc_TypeError, "rows must be tuples");
            return nullptr;
        }
        Hasher h;
        Py_ssize_t m = PyTuple_GET_SIZE(row);
        bool ok = true;
        for (Py_ssize_t j = 0; j < m && ok; j++)
            ok = feed(h, PyTuple_GET_ITEM(row, j));
        if (!ok) {
            Py_DECREF(seq);
            Py_DECREF(out);
            if (!PyErr_Occurred())
                PyErr_SetString(g_unsupported, "unsupported value type");
            return nullptr;
        }
        PyObject* key = digest_to_long(h);
        if (key == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, key);
    }
    Py_DECREF(seq);
    return out;
}

// Feed a small (64-bit) signed int exactly like the PyLong branch of
// feed(): n = (bit_length + 8)//8 + 1 bytes, signed little-endian.
// Templated over the sink for the same reason feed() is.
template <typename Sink>
inline void feed_small_int(Sink& h, long long val) {
    unsigned long long mag =
        val < 0 ? (unsigned long long)(-(val + 1)) + 1ULL
                : (unsigned long long)val;
    int bl = mag ? 64 - __builtin_clzll(mag) : 0;
    int n = (bl + 8) / 8 + 1;
    uint8_t buf[16];
    long long x = val;
    for (int i = 0; i < n; i++) {
        buf[i] = (uint8_t)(x & 0xff);
        x >>= 8;
    }
    h.tag(0x02);
    h.bytes(buf, n);
}

// Feed any PyLong (including a Pointer) as a PLAIN int — tag 0x02 signed
// little-endian, matching ref_scalar(int(v)).  Returns false (no
// exception or cleared) when the value exceeds the big-int window.
bool feed_pylong_plain(Hasher& h, PyObject* v) {
    int overflow = 0;
    long long val = PyLong_AsLongLongAndOverflow(v, &overflow);
    if (overflow == 0) {
        if (val == -1 && PyErr_Occurred()) {
            PyErr_Clear();
            return false;
        }
        feed_small_int(h, val);
        return true;
    }
    size_t bits = pt_long_numbits(v);
    if (bits == (size_t)-1) {
        PyErr_Clear();
        return false;
    }
    size_t nb = (bits + 8) / 8 + 1;
    uint8_t buf[64];
    if (nb > sizeof(buf)) return false;
    if (pt_long_as_bytes_signed(v, buf, nb) < 0) {
        PyErr_Clear();
        return false;
    }
    h.tag(0x02);
    h.bytes(buf, nb);
    return true;
}

PyObject* py_hash_prefix_ints(PyObject*, PyObject* args) {
    // (prefix_tuple, seq_ints, offset=0) -> list of Pointer
    //
    // Bulk key generation for sequentially numbered connector rows
    // (io/fs emit_rows): the prefix ("__fs__", tag, path) hash state is
    // computed ONCE and copied per row, so neither the per-row Python
    // key tuple nor the re-hash of the constant prefix exists.  Rows
    // become Pointer objects here (one C call) instead of a Python
    // listcomp over hash_rows output.  Byte-identical to
    // ref_scalar(*prefix, seq + offset).
    PyObject* prefix;
    PyObject* seqs;
    long long offset = 0;
    if (!PyArg_ParseTuple(args, "O!O|L", &PyTuple_Type, &prefix, &seqs,
                          &offset))
        return nullptr;
    if (g_pointer_type == nullptr) {
        PyErr_SetString(g_unsupported, "Pointer type not registered");
        return nullptr;
    }
    Hasher base;
    Py_ssize_t m = PyTuple_GET_SIZE(prefix);
    for (Py_ssize_t j = 0; j < m; j++) {
        if (!feed(base, PyTuple_GET_ITEM(prefix, j))) {
            if (!PyErr_Occurred())
                PyErr_SetString(g_unsupported, "unsupported value type");
            return nullptr;
        }
    }
    PyObject* seq = PySequence_Fast(seqs, "hash_prefix_ints expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* s = PySequence_Fast_GET_ITEM(seq, i);
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(s, &overflow);
        if (overflow != 0 || (v == -1 && PyErr_Occurred())) {
            Py_DECREF(seq);
            Py_DECREF(out);
            if (!PyErr_Occurred())
                PyErr_SetString(g_unsupported, "seq out of int64 range");
            return nullptr;
        }
        Hasher h = base;  // copy of the prefix hash state
        feed_small_int(h, v + offset);
        PyObject* num = digest_to_long(h);
        if (num == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyObject* ptr = pointer_from_long(num);
        if (ptr == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, ptr);
    }
    Py_DECREF(seq);
    return out;
}

PyObject* py_scan_lines(PyObject*, PyObject* arg) {
    // bytes -> list of (start, end) offsets of non-empty lines
    char* data;
    Py_ssize_t len;
    if (PyBytes_AsStringAndSize(arg, &data, &len) < 0) return nullptr;
    std::vector<std::pair<Py_ssize_t, Py_ssize_t>> spans;
    Py_ssize_t start = 0;
    for (Py_ssize_t i = 0; i <= len; i++) {
        if (i == len || data[i] == '\n') {
            Py_ssize_t end = i;
            if (end > start && data[end - 1] == '\r') end--;
            if (end > start) spans.emplace_back(start, end);
            start = i + 1;
        }
    }
    PyObject* out = PyList_New((Py_ssize_t)spans.size());
    if (out == nullptr) return nullptr;
    for (size_t i = 0; i < spans.size(); i++) {
        PyObject* t = Py_BuildValue("(nn)", spans[i].first, spans[i].second);
        if (t == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, (Py_ssize_t)i, t);
    }
    return out;
}

// --------------------------------------------------------------------------
// update-stream batch ops

// Update is a Python NamedTuple (engine/stream.py); instances are plain
// tuple subclass objects, so tuple's own tp_new builds them without going
// through the Python-level __new__ (same trick as namedtuple._make).
PyObject* make_update_obj(PyObject* cls, PyObject* key, PyObject* values,
                          PyObject* diff) {
    // Update is a NamedTuple: no state beyond the tuple items, and its
    // generated __new__ is a Python function — allocate the tuple
    // subclass directly (what tuple.__new__ itself does) instead of
    // calling it
    PyTypeObject* t = reinterpret_cast<PyTypeObject*>(cls);
    PyObject* u = t->tp_alloc(t, 3);
    if (u == nullptr) return nullptr;
    Py_INCREF(key);
    Py_INCREF(values);
    Py_INCREF(diff);
    PyTuple_SET_ITEM(u, 0, key);
    PyTuple_SET_ITEM(u, 1, values);
    PyTuple_SET_ITEM(u, 2, diff);
    return u;
}

PyObject* make_update(PyObject* cls, PyObject* key, PyObject* values,
                      long long diff) {
    PyObject* d = PyLong_FromLongLong(diff);
    if (d == nullptr) return nullptr;
    PyObject* u = make_update_obj(cls, key, values, d);
    Py_DECREF(d);
    return u;
}

struct ConsEntry {
    PyObject* first;   // borrowed from seq until output
    PyObject* key;     // borrowed
    PyObject* values;  // borrowed
    long long diff;
    bool merged;
};

PyObject* py_consolidate(PyObject*, PyObject* args) {
    PyObject *batch, *update_cls, *hashable_row;
    if (!PyArg_ParseTuple(args, "OOO", &batch, &update_cls, &hashable_row))
        return nullptr;
    PyObject* seq = PySequence_Fast(batch, "consolidate expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* acc = PyDict_New();  // (key, row) -> index into entries
    if (acc == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    std::vector<ConsEntry> entries;
    entries.reserve((size_t)n);
    bool fail = false;
    for (Py_ssize_t i = 0; i < n && !fail; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            fail = true;
            break;
        }
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        long long diff = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
        if (diff == -1 && PyErr_Occurred()) {
            fail = true;
            break;
        }
        PyObject* k2 = PyTuple_Pack(2, key, values);
        if (k2 == nullptr) {
            fail = true;
            break;
        }
        PyObject* found = PyDict_GetItemWithError(acc, k2);
        if (found == nullptr && PyErr_Occurred()) {
            if (!PyErr_ExceptionMatches(PyExc_TypeError)) {
                Py_DECREF(k2);
                fail = true;
                break;
            }
            // unhashable cell (ndarray/dict/list): type-tagged fallback key
            PyErr_Clear();
            Py_DECREF(k2);
            PyObject* tagged = PyObject_CallFunctionObjArgs(
                hashable_row, values, nullptr);
            if (tagged == nullptr) {
                fail = true;
                break;
            }
            k2 = PyTuple_Pack(2, key, tagged);
            Py_DECREF(tagged);
            if (k2 == nullptr) {
                fail = true;
                break;
            }
            found = PyDict_GetItemWithError(acc, k2);
            if (found == nullptr && PyErr_Occurred()) {
                Py_DECREF(k2);
                fail = true;
                break;
            }
        }
        if (found != nullptr) {
            size_t idx = (size_t)PyLong_AsSsize_t(found);
            entries[idx].diff += diff;
            entries[idx].merged = true;
            Py_DECREF(k2);
        } else {
            PyObject* idx = PyLong_FromSsize_t((Py_ssize_t)entries.size());
            if (idx == nullptr || PyDict_SetItem(acc, k2, idx) < 0) {
                Py_XDECREF(idx);
                Py_DECREF(k2);
                fail = true;
                break;
            }
            Py_DECREF(idx);
            Py_DECREF(k2);
            entries.push_back({u, key, values, diff, false});
        }
    }
    Py_DECREF(acc);
    if (fail) {
        Py_DECREF(seq);
        return nullptr;
    }
    PyObject* out = PyList_New(0);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (const ConsEntry& e : entries) {
        if (e.diff == 0) continue;
        PyObject* u;
        if (!e.merged) {
            u = e.first;  // unchanged: re-emit the input object
            Py_INCREF(u);
        } else {
            u = make_update(update_cls, e.key, e.values, e.diff);
            if (u == nullptr) {
                Py_DECREF(out);
                Py_DECREF(seq);
                return nullptr;
            }
        }
        if (PyList_Append(out, u) < 0) {
            Py_DECREF(u);
            Py_DECREF(out);
            Py_DECREF(seq);
            return nullptr;
        }
        Py_DECREF(u);
    }
    Py_DECREF(seq);
    return out;
}

PyObject* py_per_key_changes(PyObject*, PyObject* batch) {
    PyObject* seq = PySequence_Fast(batch, "per_key_changes expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyDict_New();
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* key = PyTuple_GET_ITEM(u, 0);
            PyObject* values = PyTuple_GET_ITEM(u, 1);
            long long diff = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
            if (diff == -1 && PyErr_Occurred()) goto fail;
            PyObject* pair = PyDict_GetItemWithError(out, key);
            if (pair == nullptr) {
                if (PyErr_Occurred()) goto fail;
                PyObject* rem = PyList_New(0);
                PyObject* add = PyList_New(0);
                if (rem == nullptr || add == nullptr) {
                    Py_XDECREF(rem);
                    Py_XDECREF(add);
                    goto fail;
                }
                pair = PyTuple_Pack(2, rem, add);
                Py_DECREF(rem);
                Py_DECREF(add);
                if (pair == nullptr || PyDict_SetItem(out, key, pair) < 0) {
                    Py_XDECREF(pair);
                    goto fail;
                }
                Py_DECREF(pair);  // dict holds it; borrow below
                pair = PyDict_GetItemWithError(out, key);
                if (pair == nullptr) goto fail;
            }
            PyObject* lst = PyTuple_GET_ITEM(pair, diff < 0 ? 0 : 1);
            long long reps = diff < 0 ? -diff : diff;
            for (long long r = 0; r < reps; r++) {
                if (PyList_Append(lst, values) < 0) goto fail;
            }
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

PyObject* py_build_adds(PyObject*, PyObject* args) {
    PyObject *rows, *update_cls;
    if (!PyArg_ParseTuple(args, "OO", &rows, &update_cls)) return nullptr;
    PyObject* seq = PySequence_Fast(rows, "build_adds expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* kv = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *key, *values;
        if (PyTuple_Check(kv) && PyTuple_GET_SIZE(kv) == 2) {
            key = PyTuple_GET_ITEM(kv, 0);
            values = PyTuple_GET_ITEM(kv, 1);
        } else {
            PyErr_SetString(PyExc_TypeError, "rows must be (key, values) pairs");
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyObject* u = make_update(update_cls, key, values, 1);
        if (u == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, u);
    }
    Py_DECREF(seq);
    return out;
}

PyObject* py_all_positive(PyObject*, PyObject* batch) {
    // True iff every update's diff > 0 (append-only batch check)
    PyObject* seq = PySequence_Fast(batch, "all_positive expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            return nullptr;
        }
        long long diff = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
        if (diff == -1 && PyErr_Occurred()) {
            Py_DECREF(seq);
            return nullptr;
        }
        if (diff <= 0) {
            Py_DECREF(seq);
            Py_RETURN_FALSE;
        }
    }
    Py_DECREF(seq);
    Py_RETURN_TRUE;
}

PyObject* py_all_dicts(PyObject*, PyObject* obj) {
    PyObject* seq = PySequence_Fast(obj, "all_dicts expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!PyDict_Check(PySequence_Fast_GET_ITEM(seq, i))) {
            Py_DECREF(seq);
            Py_RETURN_FALSE;
        }
    }
    Py_DECREF(seq);
    Py_RETURN_TRUE;
}

PyObject* py_rowwise_map(PyObject*, PyObject* args) {
    // rowwise_map(batch, fn, update_cls, error_obj, on_error) -> list
    // C loop of the expression_table hot path: vals = fn(key, values);
    // a raising row becomes (ERROR,) after on_error(exc).
    PyObject *batch, *fn, *update_cls, *error_obj, *on_error;
    if (!PyArg_ParseTuple(args, "OOOOO", &batch, &fn, &update_cls, &error_obj,
                          &on_error))
        return nullptr;
    PyObject* seq = PySequence_Fast(batch, "rowwise_map expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* key = PyTuple_GET_ITEM(u, 0);
            PyObject* values = PyTuple_GET_ITEM(u, 1);
            PyObject* diff = PyTuple_GET_ITEM(u, 2);
            PyObject* vals =
                PyObject_CallFunctionObjArgs(fn, key, values, nullptr);
            if (vals == nullptr) {
                // row-level containment (Exception only, like the Python
                // `except Exception`): report and emit an ERROR row
                if (!PyErr_ExceptionMatches(PyExc_Exception)) goto fail;
                PyObject *etype, *evalue, *etb;
                PyErr_Fetch(&etype, &evalue, &etb);
                PyErr_NormalizeException(&etype, &evalue, &etb);
                PyObject* r = PyObject_CallFunctionObjArgs(
                    on_error, evalue ? evalue : Py_None, nullptr);
                Py_XDECREF(etype);
                Py_XDECREF(evalue);
                Py_XDECREF(etb);
                if (r == nullptr) goto fail;
                Py_DECREF(r);
                vals = PyTuple_Pack(1, error_obj);
                if (vals == nullptr) goto fail;
            }
            PyObject* nu = make_update_obj(update_cls, key, vals, diff);
            Py_DECREF(vals);
            if (nu == nullptr) goto fail;
            PyList_SET_ITEM(out, i, nu);
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

// the groupby fast path only needs the (rare) rows whose cells contain
// the ERROR sentinel — scanning for them per row in Python costs more
// than the whole native aggregation; this is one identity-compare pass
PyObject* py_rows_with_error(PyObject*, PyObject* args) {
    PyObject *batch, *sentinel;
    if (!PyArg_ParseTuple(args, "OO", &batch, &sentinel)) return nullptr;
    PyObject* seq =
        PySequence_Fast(batch, "rows_with_error expects a sequence");
    if (seq == nullptr) return nullptr;
    PyObject* out = PyList_New(0);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* values = PyTuple_GET_ITEM(u, 1);
            if (!PyTuple_Check(values)) {
                PyErr_SetString(PyExc_TypeError, "values must be tuples");
                goto fail;
            }
            Py_ssize_t nv = PyTuple_GET_SIZE(values);
            for (Py_ssize_t j = 0; j < nv; j++) {
                if (PyTuple_GET_ITEM(values, j) == sentinel) {
                    if (PyList_Append(out, u) < 0) goto fail;
                    break;
                }
            }
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

PyObject* py_filter_batch(PyObject*, PyObject* args) {
    // filter_batch(batch, pred, error_obj) -> list re-emitting the PASSING
    // input update objects unchanged (no allocation per surviving row).
    // Drop semantics mirror FilterNode: raising rows, None, and ERROR all
    // drop; anything else keeps by truthiness.
    PyObject *batch, *pred, *error_obj;
    if (!PyArg_ParseTuple(args, "OOO", &batch, &pred, &error_obj))
        return nullptr;
    PyObject* seq = PySequence_Fast(batch, "filter_batch expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(0);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* r = PyObject_CallFunctionObjArgs(
                pred, PyTuple_GET_ITEM(u, 0), PyTuple_GET_ITEM(u, 1),
                nullptr);
            if (r == nullptr) {
                if (!PyErr_ExceptionMatches(PyExc_Exception)) goto fail;
                PyErr_Clear();
                continue;  // raising predicate: drop the row
            }
            if (r == Py_None || r == error_obj) {
                Py_DECREF(r);
                continue;
            }
            int truthy = PyObject_IsTrue(r);
            Py_DECREF(r);
            // a raising truthiness test propagates (python parity: only
            // the predicate CALL is containable, bool(keep) is not)
            if (truthy < 0) goto fail;
            if (truthy && PyList_Append(out, u) < 0) goto fail;
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

// --------------------------------------------------------------------------
// groupby partial aggregation
//
// groupby_partials(batch, group_idx, red_specs, error_obj, hashable_fn)
// reduces an update batch into per-group PARTIAL aggregates in one C pass
// — the role of the reference's reduce arrangement inner loop
// (src/engine/reduce.rs SemigroupReducerImpl).  Python merges one partial
// per (dirty group, reducer) into the persistent accumulators, so the
// per-row interpreter work (group_fn, arg_fn, reducer.update) disappears.
//
// red_specs: tuple of (code, idx_tuple); idx >= 0 -> values[idx],
// idx == -1 -> row key.  Codes: 0 = count (partial: int), 1 = sum-like
// (partial: (total|None, n_contributions)), 2 = multiset (partial:
// {hashable_args: (delta, args)}).

struct MsItem {
    long long delta;
    PyObject* args;  // owned
    PyObject* h;     // owned
};

struct GPart {
    PyObject* total = nullptr;  // owned (sum-like)
    long long cnt = 0;
    PyObject* msdict = nullptr;  // owned: h -> PyLong index (multiset)
    std::vector<MsItem> msitems;
};

struct GEntry {
    long long count = 0;
    std::vector<GPart> parts;
};

void free_gentries(std::vector<GEntry>& entries) {
    for (GEntry& e : entries) {
        for (GPart& p : e.parts) {
            Py_XDECREF(p.total);
            Py_XDECREF(p.msdict);
            for (MsItem& it : p.msitems) {
                Py_XDECREF(it.args);
                Py_XDECREF(it.h);
            }
        }
    }
    entries.clear();
}

PyObject* py_groupby_partials(PyObject*, PyObject* args) {
    PyObject *batch, *group_idx, *red_specs, *error_obj, *hashable_fn;
    if (!PyArg_ParseTuple(args, "OOOOO", &batch, &group_idx, &red_specs,
                          &error_obj, &hashable_fn))
        return nullptr;

    // unpack specs
    if (!PyTuple_Check(group_idx) || !PyTuple_Check(red_specs)) {
        PyErr_SetString(PyExc_TypeError, "group_idx/red_specs must be tuples");
        return nullptr;
    }
    Py_ssize_t ngroup = PyTuple_GET_SIZE(group_idx);
    std::vector<Py_ssize_t> gidx((size_t)ngroup);
    for (Py_ssize_t i = 0; i < ngroup; i++) {
        gidx[(size_t)i] = PyLong_AsSsize_t(PyTuple_GET_ITEM(group_idx, i));
        if (gidx[(size_t)i] == -1 && PyErr_Occurred()) return nullptr;
    }
    Py_ssize_t nred = PyTuple_GET_SIZE(red_specs);
    std::vector<int> rcodes((size_t)nred);
    std::vector<std::vector<Py_ssize_t>> ridx((size_t)nred);
    for (Py_ssize_t r = 0; r < nred; r++) {
        PyObject* spec = PyTuple_GET_ITEM(red_specs, r);
        if (!PyTuple_Check(spec) || PyTuple_GET_SIZE(spec) != 2) {
            PyErr_SetString(PyExc_TypeError, "red_specs items must be pairs");
            return nullptr;
        }
        long code = PyLong_AsLong(PyTuple_GET_ITEM(spec, 0));
        if (code == -1 && PyErr_Occurred()) return nullptr;
        rcodes[(size_t)r] = (int)code;
        PyObject* idxs = PyTuple_GET_ITEM(spec, 1);
        if (!PyTuple_Check(idxs)) {
            PyErr_SetString(PyExc_TypeError, "red spec idx must be a tuple");
            return nullptr;
        }
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(idxs); j++) {
            Py_ssize_t v = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, j));
            if (v == -1 && PyErr_Occurred()) return nullptr;
            ridx[(size_t)r].push_back(v);
        }
    }

    PyObject* seq = PySequence_Fast(batch, "batch must be a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);

    PyObject* gmap = PyDict_New();  // gvals -> PyLong entry index
    std::vector<GEntry> entries;
    std::vector<PyObject*> gvals_by_entry;  // borrowed (gmap holds refs)
    if (gmap == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }

    bool fail = false;
    bool unsupported = false;
    for (Py_ssize_t i = 0; i < n && !fail; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            fail = true;
            break;
        }
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        if (!PyTuple_Check(values)) {
            PyErr_SetString(g_unsupported, "values must be tuples");
            fail = true;
            break;
        }
        Py_ssize_t nvals = PyTuple_GET_SIZE(values);
        long long diff = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
        if (diff == -1 && PyErr_Occurred()) {
            fail = true;
            break;
        }
        // group key tuple
        PyObject* gv = PyTuple_New(ngroup);
        if (gv == nullptr) {
            fail = true;
            break;
        }
        for (Py_ssize_t j = 0; j < ngroup; j++) {
            Py_ssize_t ix = gidx[(size_t)j];
            PyObject* cell;
            if (ix < 0) {
                cell = key;
            } else if (ix < nvals) {
                cell = PyTuple_GET_ITEM(values, ix);
            } else {
                PyErr_SetString(g_unsupported, "column index out of range");
                Py_DECREF(gv);
                fail = true;
                break;
            }
            Py_INCREF(cell);
            PyTuple_SET_ITEM(gv, j, cell);
        }
        if (fail) break;
        PyObject* found = PyDict_GetItemWithError(gmap, gv);
        if (found == nullptr && PyErr_Occurred()) {
            // unhashable group value: whole batch falls back to Python
            Py_DECREF(gv);
            if (PyErr_ExceptionMatches(PyExc_TypeError)) {
                PyErr_Clear();
                unsupported = true;
            }
            fail = true;
            break;
        }
        size_t ei;
        if (found != nullptr) {
            ei = (size_t)PyLong_AsSsize_t(found);
            Py_DECREF(gv);
        } else {
            ei = entries.size();
            PyObject* idx = PyLong_FromSsize_t((Py_ssize_t)ei);
            if (idx == nullptr || PyDict_SetItem(gmap, gv, idx) < 0) {
                Py_XDECREF(idx);
                Py_DECREF(gv);
                fail = true;
                break;
            }
            Py_DECREF(idx);
            gvals_by_entry.push_back(gv);
            Py_DECREF(gv);  // gmap key holds the reference
            entries.emplace_back();
            entries.back().parts.resize((size_t)nred);
        }
        GEntry& ge = entries[ei];
        ge.count += diff;
        for (Py_ssize_t r = 0; r < nred && !fail; r++) {
            GPart& part = ge.parts[(size_t)r];
            int code = rcodes[(size_t)r];
            if (code == 0) continue;  // count: uses ge.count
            if (code == 1) {
                Py_ssize_t ix = ridx[(size_t)r][0];
                PyObject* v = ix < 0 ? key
                              : ix < nvals ? PyTuple_GET_ITEM(values, ix)
                                           : nullptr;
                if (v == nullptr) {
                    PyErr_SetString(g_unsupported, "column index out of range");
                    fail = true;
                    break;
                }
                if (v == Py_None || v == error_obj) continue;
                PyObject* term;
                if (diff == 1 && (PyLong_Check(v) || PyFloat_Check(v))) {
                    // immutable scalars may alias; everything else (ndarray!)
                    // must copy via v * diff like the Python reducer does
                    term = v;
                    Py_INCREF(term);
                } else {
                    PyObject* d = PyLong_FromLongLong(diff);
                    if (d == nullptr) {
                        fail = true;
                        break;
                    }
                    term = PyNumber_Multiply(v, d);
                    Py_DECREF(d);
                    if (term == nullptr) {
                        fail = true;
                        break;
                    }
                }
                if (part.total == nullptr) {
                    part.total = term;
                } else {
                    PyObject* s = PyNumber_Add(part.total, term);
                    Py_DECREF(term);
                    if (s == nullptr) {
                        fail = true;
                        break;
                    }
                    Py_DECREF(part.total);
                    part.total = s;
                }
                part.cnt += diff;
            } else {  // code == 2: multiset of args
                const std::vector<Py_ssize_t>& idxs = ridx[(size_t)r];
                PyObject* margs = PyTuple_New((Py_ssize_t)idxs.size());
                if (margs == nullptr) {
                    fail = true;
                    break;
                }
                for (size_t j = 0; j < idxs.size(); j++) {
                    Py_ssize_t ix = idxs[j];
                    PyObject* cell;
                    if (ix < 0) {
                        cell = key;
                    } else if (ix < nvals) {
                        cell = PyTuple_GET_ITEM(values, ix);
                    } else {
                        PyErr_SetString(g_unsupported,
                                        "column index out of range");
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                    Py_INCREF(cell);
                    PyTuple_SET_ITEM(margs, (Py_ssize_t)j, cell);
                }
                if (fail) break;
                if (part.msdict == nullptr) {
                    part.msdict = PyDict_New();
                    if (part.msdict == nullptr) {
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                }
                PyObject* h = margs;  // try the raw tuple as hash key first
                Py_INCREF(h);
                PyObject* mf = PyDict_GetItemWithError(part.msdict, h);
                if (mf == nullptr && PyErr_Occurred()) {
                    if (!PyErr_ExceptionMatches(PyExc_TypeError)) {
                        Py_DECREF(h);
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                    PyErr_Clear();
                    Py_DECREF(h);
                    h = PyObject_CallFunctionObjArgs(hashable_fn, margs,
                                                     nullptr);
                    if (h == nullptr) {
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                    mf = PyDict_GetItemWithError(part.msdict, h);
                    if (mf == nullptr && PyErr_Occurred()) {
                        Py_DECREF(h);
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                }
                if (mf != nullptr) {
                    size_t mi = (size_t)PyLong_AsSsize_t(mf);
                    part.msitems[mi].delta += diff;
                    Py_DECREF(h);
                    Py_DECREF(margs);
                } else {
                    PyObject* mi =
                        PyLong_FromSsize_t((Py_ssize_t)part.msitems.size());
                    if (mi == nullptr ||
                        PyDict_SetItem(part.msdict, h, mi) < 0) {
                        Py_XDECREF(mi);
                        Py_DECREF(h);
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                    Py_DECREF(mi);
                    part.msitems.push_back({diff, margs, h});  // owns both
                }
            }
        }
    }
    Py_DECREF(seq);
    if (fail) {
        free_gentries(entries);
        Py_DECREF(gmap);
        if (unsupported && !PyErr_Occurred())
            PyErr_SetString(g_unsupported, "unhashable group values");
        return nullptr;
    }

    // build the result: {gvals: (count, (partial, ...))}
    PyObject* out = PyDict_New();
    if (out == nullptr) {
        free_gentries(entries);
        Py_DECREF(gmap);
        return nullptr;
    }
    for (size_t ei = 0; ei < entries.size() && !fail; ei++) {
        GEntry& ge = entries[ei];
        PyObject* parts = PyTuple_New(nred);
        if (parts == nullptr) {
            fail = true;
            break;
        }
        for (Py_ssize_t r = 0; r < nred && !fail; r++) {
            GPart& p = ge.parts[(size_t)r];
            PyObject* payload = nullptr;
            if (rcodes[(size_t)r] == 0) {
                payload = PyLong_FromLongLong(ge.count);
            } else if (rcodes[(size_t)r] == 1) {
                PyObject* tot = p.total ? p.total : Py_None;
                payload = Py_BuildValue("(OL)", tot, p.cnt);
            } else {
                payload = PyDict_New();
                if (payload != nullptr) {
                    for (MsItem& it : p.msitems) {
                        PyObject* dv =
                            Py_BuildValue("(LO)", it.delta, it.args);
                        if (dv == nullptr ||
                            PyDict_SetItem(payload, it.h, dv) < 0) {
                            Py_XDECREF(dv);
                            Py_DECREF(payload);
                            payload = nullptr;
                            break;
                        }
                        Py_DECREF(dv);
                    }
                }
            }
            if (payload == nullptr) {
                Py_DECREF(parts);
                fail = true;
                break;
            }
            PyTuple_SET_ITEM(parts, r, payload);
        }
        if (fail) break;
        PyObject* val = Py_BuildValue("(LO)", ge.count, parts);
        Py_DECREF(parts);
        if (val == nullptr ||
            PyDict_SetItem(out, gvals_by_entry[ei], val) < 0) {
            Py_XDECREF(val);
            fail = true;
            break;
        }
        Py_DECREF(val);
    }
    free_gentries(entries);
    Py_DECREF(gmap);
    if (fail) {
        Py_DECREF(out);
        return nullptr;
    }
    return out;
}

// --------------------------------------------------------------------------
// bulk schema coercion

enum CoerceCode {
    CO_ANY = 0,
    CO_INT = 1,
    CO_FLOAT = 2,
    CO_STR = 3,
    CO_BOOL = 4,
};

// mirrors io/_connector.py _column_coercer — must stay behaviour-identical
PyObject* coerce_one(PyObject* v, int code) {
    switch (code) {
        case CO_FLOAT: {
            if (PyFloat_Check(v)) break;
            if (PyLong_Check(v)) return PyNumber_Float(v);
            if (PyUnicode_Check(v)) {
                PyObject* f = PyFloat_FromString(v);
                if (f != nullptr) return f;
                PyErr_Clear();
            }
            break;
        }
        case CO_INT: {
            if (PyLong_Check(v)) break;  // bools stay bools (python parity)
            if (PyFloat_Check(v)) {
                double d = PyFloat_AS_DOUBLE(v);
                // float.is_integer() parity; PyLong_FromDouble is exact
                // for integer-valued doubles of any magnitude
                if (std::isfinite(d) && d == std::floor(d))
                    return PyLong_FromDouble(d);
                break;
            }
            if (PyUnicode_Check(v)) {
                PyObject* iv = PyLong_FromUnicodeObject(v, 10);
                if (iv != nullptr) return iv;
                PyErr_Clear();
            }
            break;
        }
        case CO_STR: {
            if (PyUnicode_Check(v)) break;
            return PyObject_Str(v);
        }
        case CO_BOOL: {
            if (PyUnicode_Check(v)) {
                PyObject* lower = PyObject_CallMethod(v, "lower", nullptr);
                if (lower == nullptr) return nullptr;
                bool truthy =
                    PyUnicode_CompareWithASCIIString(lower, "true") == 0 ||
                    PyUnicode_CompareWithASCIIString(lower, "1") == 0 ||
                    PyUnicode_CompareWithASCIIString(lower, "t") == 0 ||
                    PyUnicode_CompareWithASCIIString(lower, "yes") == 0;
                Py_DECREF(lower);
                return PyBool_FromLong(truthy ? 1 : 0);
            }
            break;
        }
        default:
            break;
    }
    Py_INCREF(v);
    return v;
}

PyObject* py_coerce_rows(PyObject*, PyObject* args) {
    // rows: list of dicts; plan: list of (name, default, code)
    PyObject *rows, *plan;
    if (!PyArg_ParseTuple(args, "OO", &rows, &plan)) return nullptr;
    PyObject* plan_seq = PySequence_Fast(plan, "plan must be a sequence");
    if (plan_seq == nullptr) return nullptr;
    Py_ssize_t ncols = PySequence_Fast_GET_SIZE(plan_seq);
    std::vector<PyObject*> names((size_t)ncols);
    std::vector<PyObject*> defaults((size_t)ncols);
    std::vector<int> codes((size_t)ncols);
    for (Py_ssize_t c = 0; c < ncols; c++) {
        PyObject* item = PySequence_Fast_GET_ITEM(plan_seq, c);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
            PyErr_SetString(PyExc_TypeError, "plan items must be 3-tuples");
            Py_DECREF(plan_seq);
            return nullptr;
        }
        names[(size_t)c] = PyTuple_GET_ITEM(item, 0);
        defaults[(size_t)c] = PyTuple_GET_ITEM(item, 1);
        long code = PyLong_AsLong(PyTuple_GET_ITEM(item, 2));
        if (code == -1 && PyErr_Occurred()) {
            Py_DECREF(plan_seq);
            return nullptr;
        }
        codes[(size_t)c] = (int)code;
    }
    PyObject* rows_seq = PySequence_Fast(rows, "rows must be a sequence");
    if (rows_seq == nullptr) {
        Py_DECREF(plan_seq);
        return nullptr;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(rows_seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(plan_seq);
        Py_DECREF(rows_seq);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* row = PySequence_Fast_GET_ITEM(rows_seq, i);
        if (!PyDict_Check(row)) {
            PyErr_SetString(g_unsupported, "rows must be dicts");
            goto fail;
        }
        {
            PyObject* tup = PyTuple_New(ncols);
            if (tup == nullptr) goto fail;
            for (Py_ssize_t c = 0; c < ncols; c++) {
                PyObject* v = PyDict_GetItemWithError(row, names[(size_t)c]);
                if (v == nullptr && PyErr_Occurred()) {
                    Py_DECREF(tup);
                    goto fail;
                }
                if (v == nullptr || v == Py_None) v = defaults[(size_t)c];
                PyObject* cv;
                if (v == nullptr || v == Py_None) {
                    cv = Py_None;
                    Py_INCREF(cv);
                } else {
                    cv = coerce_one(v, codes[(size_t)c]);
                    if (cv == nullptr) {
                        Py_DECREF(tup);
                        goto fail;
                    }
                }
                PyTuple_SET_ITEM(tup, c, cv);
            }
            PyList_SET_ITEM(out, i, tup);
        }
    }
    Py_DECREF(plan_seq);
    Py_DECREF(rows_seq);
    return out;
fail:
    Py_DECREF(plan_seq);
    Py_DECREF(rows_seq);
    Py_DECREF(out);
    return nullptr;
}

// --------------------------------------------------------------------------
// worker routing

// route_split(batch, idx_tuple, n_workers) -> [outbox_0, ..., outbox_W-1]
// One C pass splitting an update batch by the 128-bit hash of positional
// route cells (idx >= 0 -> values[idx], -1 -> row key) — byte-identical
// to cluster.stable_shard / keys.ref_scalar, including the repr fallback
// for unhashable cell types.
// Route cells are drawn from a small domain (group keys, join keys)
// while batches run to millions of rows, so the per-row BLAKE2b is
// mostly recomputation: memoize the digest by the serialized cell
// bytes.  The hash is a pure function of those bytes, so entries can
// never go stale, and caching the digest (not the destination) keeps
// the memo worker-count independent.  GIL-protected — route_split never
// releases it.  Past the cap we stop inserting: a high-cardinality
// route keeps its first entries hot and pays the hash for the rest.
struct RouteDigest {
    uint8_t b[16];
};
constexpr size_t kRouteMemoCap = 1 << 13;
std::string g_route_buf;
std::unordered_map<std::string, RouteDigest> g_route_memo;

void route_digest(const std::string& cells, uint8_t out[16]) {
    auto it = g_route_memo.find(cells);
    if (it != g_route_memo.end()) {
        std::memcpy(out, it->second.b, 16);
        return;
    }
    Hasher h;
    h.bytes(cells.data(), cells.size());
    pwnative::blake2b_final(&h.S, out);
    if (g_route_memo.size() < kRouteMemoCap) {
        RouteDigest d;
        std::memcpy(d.b, out, 16);
        g_route_memo.emplace(cells, d);
    }
}

PyObject* py_route_split(PyObject*, PyObject* args) {
    PyObject *batch, *idxs;
    long W;
    if (!PyArg_ParseTuple(args, "OOl", &batch, &idxs, &W)) return nullptr;
    if (W <= 0 || !PyTuple_Check(idxs)) {
        PyErr_SetString(PyExc_ValueError, "bad route_split arguments");
        return nullptr;
    }
    Py_ssize_t nidx = PyTuple_GET_SIZE(idxs);
    std::vector<Py_ssize_t> pos((size_t)nidx);
    for (Py_ssize_t i = 0; i < nidx; i++) {
        pos[(size_t)i] = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, i));
        if (pos[(size_t)i] == -1 && PyErr_Occurred()) return nullptr;
    }
    PyObject* seq = PySequence_Fast(batch, "route_split expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(W);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    for (long w = 0; w < W; w++) {
        PyObject* lst = PyList_New(0);
        if (lst == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, w, lst);
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* key = PyTuple_GET_ITEM(u, 0);
            PyObject* values = PyTuple_GET_ITEM(u, 1);
            if (!PyTuple_Check(values)) {
                PyErr_SetString(PyExc_TypeError, "values must be tuples");
                goto fail;
            }
            Py_ssize_t nvals = PyTuple_GET_SIZE(values);
            if (nidx == 0) {
                // empty idx tuple = key-value routing (route_by_key):
                // dest = int(key) % W, NOT a re-hash — matches the Python
                // route_by_key closure exactly
                PyObject* wobj = PyLong_FromLong(W);
                if (wobj == nullptr) goto fail;
                PyObject* m = PyNumber_Remainder(key, wobj);
                Py_DECREF(wobj);
                if (m == nullptr) goto fail;
                long dest = PyLong_AsLong(m);
                Py_DECREF(m);
                if (dest == -1 && PyErr_Occurred()) goto fail;
                if (PyList_Append(PyList_GET_ITEM(out, dest), u) < 0)
                    goto fail;
                continue;
            }
            g_route_buf.clear();
            ByteSink sink{g_route_buf};
            bool ok = true;
            for (Py_ssize_t j = 0; j < nidx && ok; j++) {
                Py_ssize_t ix = pos[(size_t)j];
                PyObject* cell;
                if (ix < 0) {
                    cell = key;
                } else if (ix < nvals) {
                    cell = PyTuple_GET_ITEM(values, ix);
                } else {
                    PyErr_SetString(PyExc_IndexError,
                                    "route column out of range");
                    goto fail;
                }
                ok = feed(sink, cell);
            }
            if (!ok) {
                // cell type outside the native feed set (datetime,
                // ndarray, ...): the PYTHON hasher supports more tags, so
                // punt the WHOLE batch to the per-row stable_shard path —
                // a divergent native fallback hash would route rows of
                // the same group to different workers
                if (!PyErr_Occurred())
                    PyErr_SetString(g_unsupported, "unroutable cell type");
                goto fail;
            }
            uint8_t dg[16];
            route_digest(g_route_buf, dg);
            uint64_t lo, hi;
            std::memcpy(&lo, dg, 8);
            std::memcpy(&hi, dg + 8, 8);
            unsigned __int128 v =
                ((unsigned __int128)hi << 64) | (unsigned __int128)lo;
            long dest = (long)(unsigned long long)(v % (unsigned long long)W);
            if (PyList_Append(PyList_GET_ITEM(out, dest), u) < 0) goto fail;
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

// --------------------------------------------------------------------------
// WordPiece tokenization (ASCII fast path)
//
// The BERT tokenize pipeline (models/wordpiece.py) is the host-side
// bottleneck of the embedding path.  This implements the exact pipeline
// for ASCII text — clean/control/whitespace handling, lowercasing,
// punctuation splitting, greedy longest-match-first WordPiece — in one C
// pass per text; non-ASCII texts return None so the caller falls back to
// the Python implementation per text (identical output either way: on
// ASCII input NFD accent-stripping and CJK spacing are no-ops).

struct WpVocab {
    std::unordered_map<std::string, int> map;
    int unk;
    int max_chars;
    size_t max_token_len = 0;  // longest vocab entry, bounds the scan
};

void wp_free(PyObject* cap) {
    delete static_cast<WpVocab*>(PyCapsule_GetPointer(cap, "pw.wordpiece"));
}

bool wp_is_punct(unsigned char c) {
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

PyObject* py_wp_build(PyObject*, PyObject* args) {
    PyObject* vocab;
    int unk, max_chars;
    if (!PyArg_ParseTuple(args, "Oii", &vocab, &unk, &max_chars))
        return nullptr;
    if (!PyDict_Check(vocab)) {
        PyErr_SetString(PyExc_TypeError, "vocab must be a dict");
        return nullptr;
    }
    auto* wv = new WpVocab{{}, unk, max_chars};
    wv->map.reserve((size_t)PyDict_Size(vocab) * 2);
    Py_ssize_t pos = 0;
    PyObject *k, *v;
    while (PyDict_Next(vocab, &pos, &k, &v)) {
        Py_ssize_t n;
        const char* s = PyUnicode_AsUTF8AndSize(k, &n);
        if (s == nullptr) {
            delete wv;
            return nullptr;
        }
        long id = PyLong_AsLong(v);
        if (id == -1 && PyErr_Occurred()) {
            delete wv;
            return nullptr;
        }
        wv->map.emplace(std::string(s, (size_t)n), (int)id);
        if ((size_t)n > wv->max_token_len) wv->max_token_len = (size_t)n;
    }
    return PyCapsule_New(wv, "pw.wordpiece", wp_free);
}

// greedy longest-match-first over one word; appends ids or a single unk
void wp_word(const WpVocab& wv, const std::string& word,
             std::vector<int>& out) {
    if ((int)word.size() > wv.max_chars) {
        out.push_back(wv.unk);
        return;
    }
    size_t start = 0;
    size_t base = out.size();
    std::string piece;
    while (start < word.size()) {
        size_t end = word.size();
        // longest vocab entry bounds the window ("##" adds 2 bytes)
        size_t limit = start + wv.max_token_len;
        if (end > limit) end = limit;
        int cur = -1;
        size_t cur_end = 0;
        while (end > start) {
            piece.clear();
            if (start > 0) piece = "##";
            piece.append(word, start, end - start);
            auto it = wv.map.find(piece);
            if (it != wv.map.end()) {
                cur = it->second;
                cur_end = end;
                break;
            }
            end--;
        }
        if (cur < 0) {
            out.resize(base);
            out.push_back(wv.unk);
            return;
        }
        out.push_back(cur);
        start = cur_end;
    }
}

PyObject* py_wp_encode(PyObject*, PyObject* args) {
    PyObject *cap, *texts;
    int lower;
    if (!PyArg_ParseTuple(args, "OOp", &cap, &texts, &lower)) return nullptr;
    auto* wv =
        static_cast<WpVocab*>(PyCapsule_GetPointer(cap, "pw.wordpiece"));
    if (wv == nullptr) return nullptr;
    PyObject* seq = PySequence_Fast(texts, "texts must be a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    std::vector<int> ids;
    std::string word;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* text = PySequence_Fast_GET_ITEM(seq, i);
        Py_ssize_t len;
        const char* s =
            PyUnicode_Check(text) ? PyUnicode_AsUTF8AndSize(text, &len)
                                  : nullptr;
        if (s == nullptr) {
            PyErr_Clear();
            Py_INCREF(Py_None);  // non-string: python path decides
            PyList_SET_ITEM(out, i, Py_None);
            continue;
        }
        bool ascii = true;
        for (Py_ssize_t j = 0; j < len; j++) {
            if ((unsigned char)s[j] >= 0x80) {
                ascii = false;
                break;
            }
        }
        if (!ascii) {
            Py_INCREF(Py_None);  // python fallback handles unicode rules
            PyList_SET_ITEM(out, i, Py_None);
            continue;
        }
        ids.clear();
        word.clear();
        for (Py_ssize_t j = 0; j <= len; j++) {
            unsigned char c = j < len ? (unsigned char)s[j] : ' ';
            if (c == 0 || (c < 0x20 && c != '\t' && c != '\n' && c != '\r') ||
                c == 0x7f)
                continue;  // _clean drops controls
            if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
                if (!word.empty()) {
                    wp_word(*wv, word, ids);
                    word.clear();
                }
                continue;
            }
            if (lower && c >= 'A' && c <= 'Z') c = (unsigned char)(c + 32);
            if (wp_is_punct(c)) {
                if (!word.empty()) {
                    wp_word(*wv, word, ids);
                    word.clear();
                }
                word.push_back((char)c);
                wp_word(*wv, word, ids);
                word.clear();
                continue;
            }
            word.push_back((char)c);
        }
        PyObject* row = PyList_New((Py_ssize_t)ids.size());
        if (row == nullptr) {
            Py_DECREF(seq);
            Py_DECREF(out);
            return nullptr;
        }
        for (size_t j = 0; j < ids.size(); j++) {
            PyObject* v = PyLong_FromLong(ids[j]);
            if (v == nullptr) {
                Py_DECREF(row);
                Py_DECREF(seq);
                Py_DECREF(out);
                return nullptr;
            }
            PyList_SET_ITEM(row, (Py_ssize_t)j, v);
        }
        PyList_SET_ITEM(out, i, row);
    }
    Py_DECREF(seq);
    return out;
}

PyObject* py_set_pointer_type(PyObject*, PyObject* cls) {
    Py_XDECREF(g_pointer_type);
    Py_INCREF(cls);
    g_pointer_type = cls;
    Py_RETURN_NONE;
}

// ===========================================================================
// Expression stack VM
//
// The reference evaluates typed expression trees entirely in Rust
// (src/engine/expression.rs:26-491): no Python enters the per-row hot
// loop of select/filter.  The TPU build's equivalent is this bytecode VM:
// internals/expr_vm.py lowers each (already build-time-typed) expression
// AST to a flat postfix program with jump-based lazy constructs
// (if_else/coalesce/fill_error evaluate only the taken branch, exactly
// like the Python closures), and the whole select/filter batch runs in
// one C call.  Subtrees the lowerer cannot express (UDF apply, namespace
// methods) compile to their ordinary Python closure and appear as one
// CALL_PY instruction — mixed rows still avoid the per-node closure
// dispatch for everything else.
//
// Error semantics are byte-compatible with the Python closures in
// internals/expression.py:
//   - ERROR operands propagate (checked by identity before every op)
//   - TypeError with a None operand: `== -> a is b`, `!= -> a is not b`,
//     any other op -> None
//   - TypeError otherwise, ZeroDivisionError, ValueError, OverflowError
//     -> ERROR
//   - any other exception aborts the ROW (containment + error-log happen
//     in the batch loop, mirroring rowwise_map: the row becomes (ERROR,))

PyObject* g_json_type = nullptr;  // pathway_tpu_torch Json class (VM convert/get)

PyObject* py_set_json_type(PyObject*, PyObject* cls) {
    Py_XDECREF(g_json_type);
    Py_INCREF(cls);
    g_json_type = cls;
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------------------
// Native namespace methods (.str / .dt / .num).
//
// The reference evaluates DateTime/Duration/String expression enums
// entirely in Rust (src/engine/expression.rs:26-340); the first VM
// shipped every namespace method as a per-row CALL_PY closure.  These
// implementations move the high-traffic methods into the VM: Python
// semantics are pinned by the closure lambdas in
// internals/expressions.py and the differential tests in
// tests/test_expr_vm.py — on any input outside a method's native domain
// the op either falls through to calling the underlying Python method
// on the single value, or produces ERROR exactly where the closure
// would.

enum VmMethod : int64_t {
    M_STR_LOWER = 0, M_STR_UPPER, M_STR_SWAPCASE, M_STR_TITLE,
    M_STR_REVERSED, M_STR_LEN,
    M_STR_STRIP, M_STR_LSTRIP, M_STR_RSTRIP,   // arity 1 or 2
    M_STR_COUNT, M_STR_FIND, M_STR_RFIND,      // find: arity 3 or 4
    M_STR_STARTSWITH, M_STR_ENDSWITH,
    M_STR_REPLACE, M_STR_SLICE,
    M_STR_PARSE_INT, M_STR_PARSE_INT_OPT,
    M_STR_PARSE_FLOAT, M_STR_PARSE_FLOAT_OPT,
    M_STR_PARSE_BOOL, M_STR_PARSE_BOOL_OPT,
    M_STR_PARSE_DATETIME,                      // (s, fmt)
    M_DT_NANOSECOND, M_DT_MICROSECOND, M_DT_MILLISECOND,
    M_DT_SECOND, M_DT_MINUTE, M_DT_HOUR,
    M_DT_DAY, M_DT_MONTH, M_DT_YEAR,
    M_DT_DAY_OF_WEEK, M_DT_DAY_OF_YEAR,
    M_DT_TIMESTAMP,                            // (d, scale)
    M_DT_STRFTIME,                             // (d, fmt)
    M_DT_ROUND, M_DT_FLOOR,                    // (d, duration)
    M_DUR_NANOSECONDS, M_DUR_MICROSECONDS, M_DUR_MILLISECONDS,
    M_DUR_SECONDS, M_DUR_MINUTES, M_DUR_HOURS, M_DUR_DAYS, M_DUR_WEEKS,
    M_NUM_ABS, M_NUM_FILL_NA,
    M_NUM_ROUND,                               // (x, decimals)
    M_STR_SPLIT,                               // (s, maxsplit) | (s, sep, maxsplit)
    M_DT_FROM_TIMESTAMP,                       // (x, scale) -> naive UTC
    M_DT_UTC_FROM_TIMESTAMP,                   // (x, scale) -> aware UTC
    M_DT_TO_UTC,                               // (d, tz_table) naive local -> aware UTC
    M_DT_TO_NAIVE_TZ,                          // (d, tz_table) aware -> naive local
    M_METHOD_COUNT,
};

// Hinnant's civil-date algorithms (public domain): proleptic Gregorian
// days since 1970-01-01.
inline int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const int64_t yoe = y - era * 400;
    const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + doe - 719468;
}

inline void civil_from_days(int64_t z, int64_t* y, int64_t* m, int64_t* d) {
    z += 719468;
    const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
    const int64_t doe = z - era * 146097;
    const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
    const int64_t yy = yoe + era * 400;
    const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
    const int64_t mp = (5 * doy + 2) / 153;
    *d = doy - (153 * mp + 2) / 5 + 1;
    *m = mp + (mp < 10 ? 3 : -9);
    *y = yy + (*m <= 2);
}

inline bool is_leap(int64_t y) {
    return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0;
}

const int kDaysBeforeMonth[13] = {0, 0,   31,  59,  90,  120, 151,
                                  181, 212, 243, 273, 304, 334};

// timedelta.total_seconds() double formula, replicated bit-for-bit
inline double td_total_seconds(int64_t days, int64_t secs, int64_t us) {
    return ((double)(days * 86400 + secs) * 1e6 + (double)us) / 1e6;
}

PyObject* g_dt_module_cache = nullptr;  // datetime module (strptime fallback)
PyObject* g_utc_singleton = nullptr;    // datetime.timezone.utc

bool ensure_datetime_cache() {
    if (g_dt_module_cache != nullptr) return true;
    PyObject* mod = PyImport_ImportModule("datetime");
    if (mod == nullptr) return false;
    PyObject* tz = PyObject_GetAttrString(mod, "timezone");
    if (tz == nullptr) {
        Py_DECREF(mod);
        return false;
    }
    g_utc_singleton = PyObject_GetAttrString(tz, "utc");
    Py_DECREF(tz);
    if (g_utc_singleton == nullptr) {
        Py_DECREF(mod);
        return false;
    }
    g_dt_module_cache = mod;
    return true;
}

// epoch-microseconds -> datetime with the given tzinfo (Py_None = naive)
// and fold; years outside datetime's [1, 9999] raise ValueError (the
// Python closures raise the same way -> row ERROR either path).
PyObject* dt_from_epoch_us(int64_t us_total, PyObject* tzinfo, int fold) {
    int64_t days = us_total >= 0
                       ? us_total / 86400000000LL
                       : -((-us_total + 86399999999LL) / 86400000000LL);
    int64_t rem = us_total - days * 86400000000LL;  // [0, 86400e6)
    int64_t y, mo, dd;
    civil_from_days(days, &y, &mo, &dd);
    if (y < 1 || y > 9999) {
        PyErr_SetString(PyExc_ValueError, "year out of range");
        return nullptr;
    }
    int64_t s = rem / 1000000, us = rem % 1000000;
    return PyDateTimeAPI->DateTime_FromDateAndTimeAndFold(
        (int)y, (int)mo, (int)dd, (int)(s / 3600), (int)((s / 60) % 60),
        (int)(s % 60), (int)us, tzinfo, fold, PyDateTimeAPI->DateTimeType);
}

// ---- packed tz transition tables (internals/tztable.py) --------------
//
// A full table is the 9-tuple (name, trans_utc, lkeys0, lkeys1, offs,
// off_before, after_off|None, zoneinfo_instance, fallback): the pure
// Python ``zoneinfo`` transition arrays packed as native int64 byte
// strings.  ``offs[i]`` is the utc offset (whole seconds) that applies
// AFTER transition i; ``lkeys{0,1}`` are the local-side bisection keys
// for fold 0/1 (``ZoneInfo._trans_local``), ``trans_utc`` the utc-side
// keys.  A 2-tuple (name, fallback) marks a zone that could not be
// packed: every value takes the Python fallback (the exact expression
// closure).  Timestamps outside the packed range with a rule footer
// (``_TZStr`` — post-2037 for most DST zones) also fall back per value,
// so native results are bit-identical to ``zoneinfo``'s answers.

struct TzTable {
    const int64_t* trans_utc;
    const int64_t* lk0;
    const int64_t* lk1;
    const int64_t* offs;
    int64_t n;
    int64_t off_before;
    bool has_after;
    int64_t after_off;
};

bool tz_table_view(PyObject* tbl, TzTable* out) {
    Py_ssize_t nb = -1;
    const char* arrs[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < 4; i++) {
        PyObject* b = PyTuple_GET_ITEM(tbl, i + 1);
        if (!PyBytes_Check(b) || (nb >= 0 && PyBytes_GET_SIZE(b) != nb) ||
            PyBytes_GET_SIZE(b) % 8 != 0) {
            PyErr_SetString(PyExc_TypeError, "bad tz table arrays");
            return false;
        }
        nb = PyBytes_GET_SIZE(b);
        arrs[i] = PyBytes_AS_STRING(b);
    }
    out->trans_utc = reinterpret_cast<const int64_t*>(arrs[0]);
    out->lk0 = reinterpret_cast<const int64_t*>(arrs[1]);
    out->lk1 = reinterpret_cast<const int64_t*>(arrs[2]);
    out->offs = reinterpret_cast<const int64_t*>(arrs[3]);
    out->n = nb / 8;
    PyObject* ob = PyTuple_GET_ITEM(tbl, 5);
    PyObject* oa = PyTuple_GET_ITEM(tbl, 6);
    if (!PyLong_Check(ob) || (oa != Py_None && !PyLong_Check(oa))) {
        PyErr_SetString(PyExc_TypeError, "bad tz table offsets");
        return false;
    }
    out->off_before = PyLong_AsLongLong(ob);
    out->has_after = oa != Py_None;
    out->after_off = out->has_after ? PyLong_AsLongLong(oa) : 0;
    return !PyErr_Occurred();
}

// ---- strptime (Python datetime.strptime semantics for the common
// directives; anything else falls back to the Python function) ----------

struct StrpResult {
    int64_t year = 1900, month = 1, day = 1;
    int64_t hour = 0, minute = 0, second = 0, us = 0;
    int64_t yday = -1;      // %j
    int hour12 = -1;        // %I
    int ampm = -1;          // %p: 0 AM, 1 PM
    bool has_tz = false;
    int64_t tz_off_s = 0;   // %z seconds east
    int64_t tz_off_us = 0;
};

// parse up to `maxd` ASCII digits (at least 1); returns count or 0
inline int parse_digits(const char* p, const char* end, int maxd,
                        int64_t* out) {
    int n = 0;
    int64_t v = 0;
    while (n < maxd && p + n < end && p[n] >= '0' && p[n] <= '9') {
        v = v * 10 + (p[n] - '0');
        n++;
    }
    if (n == 0) return 0;
    *out = v;
    return n;
}

// Returns: 1 parsed, 0 format has an unsupported directive (caller falls
// back to Python strptime), -1 value does not match (ValueError).
int c_strptime(const char* s, Py_ssize_t slen, const char* f,
               Py_ssize_t flen, StrpResult* R) {
    const char* p = s;
    const char* pe = s + slen;
    const char* q = f;
    const char* qe = f + flen;
    while (q < qe) {
        char c = *q++;
        if (c != '%') {
            if ((unsigned char)c >= 0x80)
                return 0;  // non-ASCII literal: Unicode-aware IGNORECASE
                           // matching is Python's business
            if (c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                c == '\f' || c == '\v') {
                // Python compiles literal whitespace in the format to
                // \s+ (Lib/_strptime.py TimeRE.pattern)
                if (p >= pe || !isspace((unsigned char)*p)) return -1;
                while (p < pe && isspace((unsigned char)*p)) p++;
                while (q < qe && isspace((unsigned char)*q)) q++;
                continue;
            }
            // _strptime compiles the pattern with re.IGNORECASE, so
            // literal letters match either case
            if (p >= pe ||
                tolower((unsigned char)*p) != tolower((unsigned char)c))
                return -1;
            p++;
            continue;
        }
        if (q >= qe) return 0;  // trailing % — let Python raise its error
        char d = *q++;
        int n;
        switch (d) {
            case 'Y':
                n = parse_digits(p, pe, 4, &R->year);
                if (n == 0) return -1;
                p += n;
                break;
            case 'y':
                n = parse_digits(p, pe, 2, &R->year);
                if (n == 0) return -1;
                p += n;
                // Python 2-digit year rule (POSIX): 69-99 -> 1900s
                R->year += (R->year <= 68) ? 2000 : 1900;
                break;
            case 'm':
                n = parse_digits(p, pe, 2, &R->month);
                if (n == 0 || R->month < 1 || R->month > 12) return -1;
                p += n;
                break;
            case 'd':
                n = parse_digits(p, pe, 2, &R->day);
                if (n == 0 || R->day < 1 || R->day > 31) return -1;
                p += n;
                break;
            case 'H':
                n = parse_digits(p, pe, 2, &R->hour);
                if (n == 0 || R->hour > 23) return -1;
                p += n;
                break;
            case 'I': {
                int64_t h;
                n = parse_digits(p, pe, 2, &h);
                if (n == 0 || h < 1 || h > 12) return -1;
                R->hour12 = (int)h;
                p += n;
                break;
            }
            case 'M':
                n = parse_digits(p, pe, 2, &R->minute);
                if (n == 0 || R->minute > 59) return -1;
                p += n;
                break;
            case 'S':
                n = parse_digits(p, pe, 2, &R->second);
                if (n == 0 || R->second > 61) return -1;
                // leap seconds (60/61): let the Python implementation
                // decide what to do with them
                if (R->second > 59) return 0;
                p += n;
                break;
            case 'f': {
                int64_t v;
                n = parse_digits(p, pe, 6, &v);
                if (n == 0) return -1;
                for (int i = n; i < 6; i++) v *= 10;
                R->us = v;
                p += n;
                break;
            }
            case 'j':
                n = parse_digits(p, pe, 3, &R->yday);
                if (n == 0 || R->yday < 1 || R->yday > 366) return -1;
                p += n;
                break;
            case 'p': {
                if (p + 2 > pe) return -1;
                char a = (char)tolower((unsigned char)p[0]);
                char b = (char)tolower((unsigned char)p[1]);
                if (b != 'm' || (a != 'a' && a != 'p')) return -1;
                R->ampm = (a == 'p');
                p += 2;
                break;
            }
            case 'z': {
                // _strptime's %z branch is (?-i:Z): uppercase only
                if (p < pe && *p == 'Z') {
                    R->has_tz = true;
                    R->tz_off_s = 0;
                    p++;
                    break;
                }
                if (p >= pe || (*p != '+' && *p != '-')) return -1;
                int sign = (*p == '-') ? -1 : 1;
                p++;
                int64_t hh, mm, ss = 0;
                n = parse_digits(p, pe, 2, &hh);
                if (n != 2) return -1;
                p += n;
                if (p < pe && *p == ':') p++;
                n = parse_digits(p, pe, 2, &mm);
                if (n != 2 || mm > 59) return -1;
                p += n;
                int64_t us = 0;
                if (p < pe && (*p == ':' || (*p >= '0' && *p <= '9'))) {
                    const char* save = p;
                    if (*p == ':') p++;
                    n = parse_digits(p, pe, 2, &ss);
                    if (n == 2 && ss <= 59) {
                        p += n;
                        if (p < pe && *p == '.') {
                            p++;
                            int64_t fv;
                            n = parse_digits(p, pe, 6, &fv);
                            if (n == 0) return -1;
                            for (int i = n; i < 6; i++) fv *= 10;
                            us = fv;
                            p += n;
                        }
                    } else {
                        ss = 0;
                        p = save;  // digits belong to a later directive
                    }
                }
                R->has_tz = true;
                R->tz_off_s = sign * (hh * 3600 + mm * 60 + ss);
                R->tz_off_us = sign * us;
                break;
            }
            case '%':
                if (p >= pe || *p != '%') return -1;
                p++;
                break;
            default:
                return 0;  // %a/%A/%b/%B/%Z/%U/%W/%c/%x/%X/...: Python path
        }
    }
    if (p != pe) return -1;  // unconverted data remains
    return 1;
}

// build a datetime.timezone for an offset (Python strptime returns
// timezone.utc for Z/+00:00, else timezone(timedelta(...)))
PyObject* tz_from_offset(int64_t off_s, int64_t off_us) {
    if (!ensure_datetime_cache()) return nullptr;
    if (off_s == 0 && off_us == 0) {
        Py_INCREF(g_utc_singleton);
        return g_utc_singleton;
    }
    PyObject* delta = PyDelta_FromDSU(0, (int)off_s, (int)off_us);
    if (delta == nullptr) return nullptr;
    PyObject* tz_type = PyObject_GetAttrString(g_dt_module_cache, "timezone");
    if (tz_type == nullptr) {
        Py_DECREF(delta);
        return nullptr;
    }
    PyObject* tz = PyObject_CallFunctionObjArgs(tz_type, delta, nullptr);
    Py_DECREF(tz_type);
    Py_DECREF(delta);
    return tz;
}

// ---- strftime (numeric directives; names fall back to Python) ---------

// Returns 1 on success (out filled), 0 when the format needs the Python
// strftime (locale names), -1 on error (exception set).
int c_strftime(PyObject* d, const char* f, Py_ssize_t flen,
               std::string* out) {
    if (!PyDateTime_Check(d)) return 0;
    int64_t year = PyDateTime_GET_YEAR(d);
    int mon = PyDateTime_GET_MONTH(d);
    int day = PyDateTime_GET_DAY(d);
    int hour = PyDateTime_DATE_GET_HOUR(d);
    int minute = PyDateTime_DATE_GET_MINUTE(d);
    int sec = PyDateTime_DATE_GET_SECOND(d);
    int us = PyDateTime_DATE_GET_MICROSECOND(d);
    char buf[32];
    const char* q = f;
    const char* qe = f + flen;
    while (q < qe) {
        char c = *q++;
        if (c != '%') {
            out->push_back(c);
            continue;
        }
        if (q >= qe) {
            out->push_back('%');
            break;
        }
        char dd = *q++;
        switch (dd) {
            case 'Y':
                // glibc does not zero-pad %Y (Python delegates to it)
                snprintf(buf, sizeof buf, "%lld", (long long)year);
                out->append(buf);
                break;
            case 'y':
                snprintf(buf, sizeof buf, "%02lld",
                         (long long)(((year % 100) + 100) % 100));
                out->append(buf);
                break;
            case 'm':
                snprintf(buf, sizeof buf, "%02d", mon);
                out->append(buf);
                break;
            case 'd':
                snprintf(buf, sizeof buf, "%02d", day);
                out->append(buf);
                break;
            case 'H':
                snprintf(buf, sizeof buf, "%02d", hour);
                out->append(buf);
                break;
            case 'I': {
                int h12 = hour % 12;
                if (h12 == 0) h12 = 12;
                snprintf(buf, sizeof buf, "%02d", h12);
                out->append(buf);
                break;
            }
            case 'p':
                out->append(hour < 12 ? "AM" : "PM");
                break;
            case 'M':
                snprintf(buf, sizeof buf, "%02d", minute);
                out->append(buf);
                break;
            case 'S':
                snprintf(buf, sizeof buf, "%02d", sec);
                out->append(buf);
                break;
            case 'f':
                snprintf(buf, sizeof buf, "%06d", us);
                out->append(buf);
                break;
            case 'j': {
                int yday = kDaysBeforeMonth[mon] + day +
                           ((mon > 2 && is_leap(year)) ? 1 : 0);
                snprintf(buf, sizeof buf, "%03d", yday);
                out->append(buf);
                break;
            }
            case '%':
                out->push_back('%');
                break;
            default:
                return 0;  // %a %A %b %B %Z %z %c %x %X %G %u %V ...
        }
    }
    return 1;
}

// slice-style index clamp for str.find/slice
inline Py_ssize_t clamp_index(PyObject* idx, Py_ssize_t len, Py_ssize_t dflt,
                              bool* bad) {
    if (idx == Py_None) return dflt;
    if (!PyLong_Check(idx)) {
        *bad = true;
        return 0;
    }
    Py_ssize_t v = PyLong_AsSsize_t(idx);
    if (v == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        // magnitude beyond Py_ssize_t clamps like a slice bound; compare
        // against zero for the sign (a >1e308 int also overflows the
        // double conversion, so the sign must not go through it)
        static PyObject* zero = nullptr;
        if (zero == nullptr) zero = PyLong_FromLong(0);
        int neg =
            zero != nullptr ? PyObject_RichCompareBool(idx, zero, Py_LT) : 0;
        if (neg < 0) {
            PyErr_Clear();
            neg = 0;
        }
        return neg == 1 ? 0 : len;
    }
    if (v < 0) {
        v += len;
        if (v < 0) v = 0;
    } else if (v > len) {
        v = len;
    }
    return v;
}

// whitespace / chars-set strip over any PyUnicode kind
PyObject* str_strip_impl(PyObject* s, PyObject* chars, int left, int right) {
    if (PyUnicode_READY(s) < 0) return nullptr;
    Py_ssize_t len = PyUnicode_GET_LENGTH(s);
    int kind = PyUnicode_KIND(s);
    const void* data = PyUnicode_DATA(s);
    Py_ssize_t lo = 0, hi = len;
    if (chars == nullptr) {
        while (left && lo < hi &&
               Py_UNICODE_ISSPACE(PyUnicode_READ(kind, data, lo)))
            lo++;
        while (right && hi > lo &&
               Py_UNICODE_ISSPACE(PyUnicode_READ(kind, data, hi - 1)))
            hi--;
    } else {
        if (PyUnicode_READY(chars) < 0) return nullptr;
        Py_ssize_t clen = PyUnicode_GET_LENGTH(chars);
        int ckind = PyUnicode_KIND(chars);
        const void* cdata = PyUnicode_DATA(chars);
        auto in_set = [&](Py_UCS4 ch) {
            for (Py_ssize_t i = 0; i < clen; i++)
                if (PyUnicode_READ(ckind, cdata, i) == ch) return true;
            return false;
        };
        while (left && lo < hi && in_set(PyUnicode_READ(kind, data, lo))) lo++;
        while (right && hi > lo && in_set(PyUnicode_READ(kind, data, hi - 1)))
            hi--;
    }
    if (lo == 0 && hi == len && PyUnicode_CheckExact(s)) {
        Py_INCREF(s);
        return s;
    }
    return PyUnicode_Substring(s, lo, hi);
}

// ASCII-only case transforms; returns nullptr with no error set when the
// string needs the full Unicode algorithm (caller calls the method)
PyObject* str_ascii_case(PyObject* s, int64_t mid) {
    if (PyUnicode_READY(s) < 0) return nullptr;
    if (!PyUnicode_IS_ASCII(s)) return nullptr;
    Py_ssize_t len = PyUnicode_GET_LENGTH(s);
    const char* src = (const char*)PyUnicode_1BYTE_DATA(s);
    PyObject* out = PyUnicode_New(len, 127);
    if (out == nullptr) return nullptr;
    char* dst = (char*)PyUnicode_1BYTE_DATA(out);
    bool prev_cased = false;
    for (Py_ssize_t i = 0; i < len; i++) {
        char c = src[i];
        switch (mid) {
            case M_STR_LOWER:
                dst[i] = (char)tolower((unsigned char)c);
                break;
            case M_STR_UPPER:
                dst[i] = (char)toupper((unsigned char)c);
                break;
            case M_STR_SWAPCASE:
                dst[i] = islower((unsigned char)c)
                             ? (char)toupper((unsigned char)c)
                             : (islower((unsigned char)c) == 0 &&
                                        isupper((unsigned char)c)
                                    ? (char)tolower((unsigned char)c)
                                    : c);
                break;
            case M_STR_TITLE: {
                bool cased = isalpha((unsigned char)c) != 0;
                if (cased && !prev_cased)
                    dst[i] = (char)toupper((unsigned char)c);
                else if (cased)
                    dst[i] = (char)tolower((unsigned char)c);
                else
                    dst[i] = c;
                prev_cased = cased;
                break;
            }
            default:
                dst[i] = c;
        }
    }
    return out;
}

// method call fallback for inputs outside a native fast path: the
// single-value Python method, same result the closure lambda produces
PyObject* vm_method_pyfallback(const char* name, PyObject* self) {
    return PyObject_CallMethod(self, name, nullptr);
}

// Evaluates method `mid` over `args[0..nargs)`.  Returns a NEW reference;
// nullptr with an exception set = treat as the closure's `except` path
// (caller converts to ERROR).
PyObject* vm_method_eval(int64_t mid, PyObject** args, int64_t nargs) {
    PyObject* a0 = args[0];
    switch (mid) {
        // ---- str -----------------------------------------------------
        case M_STR_LOWER:
        case M_STR_UPPER:
        case M_STR_SWAPCASE:
        case M_STR_TITLE: {
            if (!PyUnicode_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            PyObject* r = str_ascii_case(a0, mid);
            if (r != nullptr || PyErr_Occurred()) return r;
            const char* nm = mid == M_STR_LOWER     ? "lower"
                             : mid == M_STR_UPPER   ? "upper"
                             : mid == M_STR_SWAPCASE ? "swapcase"
                                                     : "title";
            return vm_method_pyfallback(nm, a0);
        }
        case M_STR_REVERSED: {
            if (!PyUnicode_Check(a0) || PyUnicode_READY(a0) < 0) {
                if (!PyErr_Occurred())
                    PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            Py_ssize_t len = PyUnicode_GET_LENGTH(a0);
            int kind = PyUnicode_KIND(a0);
            const void* data = PyUnicode_DATA(a0);
            Py_UCS4 maxch = PyUnicode_MAX_CHAR_VALUE(a0);
            PyObject* out = PyUnicode_New(len, maxch);
            if (out == nullptr) return nullptr;
            for (Py_ssize_t i = 0; i < len; i++)
                PyUnicode_WRITE(PyUnicode_KIND(out), PyUnicode_DATA(out), i,
                                PyUnicode_READ(kind, data, len - 1 - i));
            return out;
        }
        case M_STR_LEN: {
            Py_ssize_t n = PyObject_Length(a0);
            if (n < 0) return nullptr;
            return PyLong_FromSsize_t(n);
        }
        case M_STR_STRIP:
        case M_STR_LSTRIP:
        case M_STR_RSTRIP: {
            if (!PyUnicode_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            PyObject* chars = nargs >= 2 ? args[1] : nullptr;
            if (chars != nullptr && !PyUnicode_Check(chars)) {
                PyErr_SetString(PyExc_TypeError, "strip chars must be str");
                return nullptr;
            }
            return str_strip_impl(a0, chars, mid != M_STR_RSTRIP,
                                  mid != M_STR_LSTRIP);
        }
        case M_STR_COUNT: {
            if (!PyUnicode_Check(a0) || !PyUnicode_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            Py_ssize_t n =
                PyUnicode_Count(a0, args[1], 0, PY_SSIZE_T_MAX);
            if (n < 0) return nullptr;
            return PyLong_FromSsize_t(n);
        }
        case M_STR_FIND:
        case M_STR_RFIND: {
            if (!PyUnicode_Check(a0) || !PyUnicode_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            Py_ssize_t len = PyUnicode_GET_LENGTH(a0);
            bool bad = false;
            Py_ssize_t start = clamp_index(args[1 + 1], len, 0, &bad);
            Py_ssize_t end =
                nargs >= 4 ? clamp_index(args[3], len, len, &bad) : len;
            if (bad) {
                PyErr_SetString(PyExc_TypeError, "indices must be ints");
                return nullptr;
            }
            Py_ssize_t r = PyUnicode_Find(a0, args[1], start, end,
                                          mid == M_STR_FIND ? 1 : -1);
            if (r == -2) return nullptr;
            return PyLong_FromSsize_t(r);
        }
        case M_STR_STARTSWITH:
        case M_STR_ENDSWITH: {
            if (!PyUnicode_Check(a0) || !PyUnicode_Check(args[1])) {
                // tuple prefixes etc.: defer to the Python method
                return PyObject_CallMethod(
                    a0, mid == M_STR_STARTSWITH ? "startswith" : "endswith",
                    "O", args[1]);
            }
            Py_ssize_t r = PyUnicode_Tailmatch(
                a0, args[1], 0, PY_SSIZE_T_MAX,
                mid == M_STR_STARTSWITH ? -1 : 1);
            if (r < 0) return nullptr;
            return PyBool_FromLong(r != 0);
        }
        case M_STR_REPLACE: {
            if (!PyUnicode_Check(a0) || !PyUnicode_Check(args[1]) ||
                !PyUnicode_Check(args[2]) || !PyLong_Check(args[3])) {
                PyErr_SetString(PyExc_TypeError, "bad replace arguments");
                return nullptr;
            }
            Py_ssize_t cnt = PyLong_AsSsize_t(args[3]);
            if (cnt == -1 && PyErr_Occurred()) return nullptr;
            return PyUnicode_Replace(a0, args[1], args[2], cnt);
        }
        case M_STR_SLICE: {
            if (!PyUnicode_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            Py_ssize_t len = PyUnicode_GET_LENGTH(a0);
            bool bad = false;
            Py_ssize_t lo = clamp_index(args[1], len, 0, &bad);
            Py_ssize_t hi = clamp_index(args[2], len, len, &bad);
            if (bad) {
                PyErr_SetString(PyExc_TypeError,
                                "slice indices must be integers");
                return nullptr;
            }
            if (hi < lo) hi = lo;
            return PyUnicode_Substring(a0, lo, hi);
        }
        case M_STR_PARSE_INT:
        case M_STR_PARSE_INT_OPT: {
            // int(s): the closure also accepts non-str (int(3.5) == 3)
            PyObject* r = PyUnicode_Check(a0)
                              ? PyLong_FromUnicodeObject(a0, 10)
                              : PyNumber_Long(a0);
            if (r == nullptr && mid == M_STR_PARSE_INT_OPT &&
                PyErr_ExceptionMatches(PyExc_ValueError)) {
                PyErr_Clear();
                Py_RETURN_NONE;
            }
            return r;
        }
        case M_STR_PARSE_FLOAT:
        case M_STR_PARSE_FLOAT_OPT: {
            PyObject* r = PyUnicode_Check(a0) ? PyFloat_FromString(a0)
                                              : PyNumber_Float(a0);
            if (r == nullptr && mid == M_STR_PARSE_FLOAT_OPT &&
                PyErr_ExceptionMatches(PyExc_ValueError)) {
                PyErr_Clear();
                Py_RETURN_NONE;
            }
            return r;
        }
        case M_STR_PARSE_BOOL:
        case M_STR_PARSE_BOOL_OPT: {
            // (s, true_values, false_values) — tuples of lowercase strs
            PyObject* low = PyObject_CallMethod(a0, "lower", nullptr);
            if (low == nullptr) return nullptr;
            int hit = PySequence_Contains(args[1], low);
            if (hit < 0) {
                Py_DECREF(low);
                return nullptr;
            }
            if (hit) {
                Py_DECREF(low);
                Py_RETURN_TRUE;
            }
            hit = PySequence_Contains(args[2], low);
            Py_DECREF(low);
            if (hit < 0) return nullptr;
            if (hit) Py_RETURN_FALSE;
            if (mid == M_STR_PARSE_BOOL_OPT) Py_RETURN_NONE;
            PyErr_Format(PyExc_ValueError, "Cannot parse %R as bool", a0);
            return nullptr;
        }
        case M_STR_PARSE_DATETIME: {
            Py_ssize_t slen, flen;
            const char* s = PyUnicode_AsUTF8AndSize(a0, &slen);
            if (s == nullptr) return nullptr;
            const char* f = PyUnicode_AsUTF8AndSize(args[1], &flen);
            if (f == nullptr) return nullptr;
            StrpResult R;
            int rc = c_strptime(s, slen, f, flen, &R);
            if (rc <= 0) {
                // unsupported directive (rc==0) OR native mismatch
                // (rc<0): both defer to the real datetime.strptime.  The
                // mismatch deferral is what guarantees parity — Python's
                // regex backtracks where the native parser is greedy
                // (e.g. "%H%M" over "29" parses as H=2, M=9), and \d
                // matches non-ASCII Unicode digits; rows the native
                // parser cannot handle get Python's verdict, whatever
                // it is
                if (!ensure_datetime_cache()) return nullptr;
                PyObject* dt_type =
                    PyObject_GetAttrString(g_dt_module_cache, "datetime");
                if (dt_type == nullptr) return nullptr;
                PyObject* r = PyObject_CallMethod(dt_type, "strptime", "OO",
                                                  a0, args[1]);
                Py_DECREF(dt_type);
                return r;
            }
            if (R.hour12 >= 0) {
                int h = R.hour12 % 12;
                if (R.ampm == 1) h += 12;
                R.hour = h;
            }
            if (R.yday > 0) {
                int64_t doy = R.yday;
                int64_t maxd = is_leap(R.year) ? 366 : 365;
                if (doy > maxd) {
                    PyErr_SetString(PyExc_ValueError,
                                    "day of year out of range");
                    return nullptr;
                }
                int64_t m = 1;
                while (m < 12) {
                    int64_t dim = kDaysBeforeMonth[m + 1] +
                                  ((m + 1 > 2 && is_leap(R.year)) ? 1 : 0);
                    if (doy <= dim) break;
                    m++;
                }
                R.month = m;
                R.day = doy - kDaysBeforeMonth[m] -
                        ((m > 2 && is_leap(R.year)) ? 1 : 0);
            }
            PyObject* tz = nullptr;
            if (R.has_tz) {
                tz = tz_from_offset(R.tz_off_s, R.tz_off_us);
                if (tz == nullptr) return nullptr;
            }
            PyObject* r = PyDateTimeAPI->DateTime_FromDateAndTime(
                (int)R.year, (int)R.month, (int)R.day, (int)R.hour,
                (int)R.minute, (int)R.second, (int)R.us,
                tz == nullptr ? Py_None : tz, PyDateTimeAPI->DateTimeType);
            Py_XDECREF(tz);
            return r;
        }
        // ---- datetime fields ----------------------------------------
        case M_DT_NANOSECOND:
        case M_DT_MICROSECOND:
        case M_DT_MILLISECOND:
        case M_DT_SECOND:
        case M_DT_MINUTE:
        case M_DT_HOUR:
        case M_DT_DAY:
        case M_DT_MONTH:
        case M_DT_YEAR:
        case M_DT_DAY_OF_WEEK:
        case M_DT_DAY_OF_YEAR: {
            if (!PyDateTime_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected datetime");
                return nullptr;
            }
            long long v;
            switch (mid) {
                case M_DT_NANOSECOND:
                    v = (long long)PyDateTime_DATE_GET_MICROSECOND(a0) * 1000;
                    break;
                case M_DT_MICROSECOND:
                    v = PyDateTime_DATE_GET_MICROSECOND(a0);
                    break;
                case M_DT_MILLISECOND:
                    v = PyDateTime_DATE_GET_MICROSECOND(a0) / 1000;
                    break;
                case M_DT_SECOND:
                    v = PyDateTime_DATE_GET_SECOND(a0);
                    break;
                case M_DT_MINUTE:
                    v = PyDateTime_DATE_GET_MINUTE(a0);
                    break;
                case M_DT_HOUR:
                    v = PyDateTime_DATE_GET_HOUR(a0);
                    break;
                case M_DT_DAY:
                    v = PyDateTime_GET_DAY(a0);
                    break;
                case M_DT_MONTH:
                    v = PyDateTime_GET_MONTH(a0);
                    break;
                case M_DT_YEAR:
                    v = PyDateTime_GET_YEAR(a0);
                    break;
                case M_DT_DAY_OF_WEEK: {
                    int64_t z = days_from_civil(PyDateTime_GET_YEAR(a0),
                                                PyDateTime_GET_MONTH(a0),
                                                PyDateTime_GET_DAY(a0));
                    v = (long long)(((z % 7) + 10) % 7);  // 1970-01-01 = Thu
                    break;
                }
                default: {  // day of year
                    int m = PyDateTime_GET_MONTH(a0);
                    v = kDaysBeforeMonth[m] + PyDateTime_GET_DAY(a0) +
                        ((m > 2 && is_leap(PyDateTime_GET_YEAR(a0))) ? 1 : 0);
                }
            }
            return PyLong_FromLongLong(v);
        }
        case M_DT_TIMESTAMP: {
            // (d, scale_float): naive treated as UTC (expressions.py ts())
            if (!PyDateTime_Check(a0) || !PyFloat_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "expected datetime");
                return nullptr;
            }
            PyObject* tzinfo = PyDateTime_DATE_GET_TZINFO(a0);
            int64_t off_us = 0;
            if (tzinfo != Py_None) {
                // non-trivial tz: ask Python for the offset
                PyObject* off =
                    PyObject_CallMethod(a0, "utcoffset", nullptr);
                if (off == nullptr) return nullptr;
                if (off != Py_None) {
                    if (!PyDelta_Check(off)) {
                        Py_DECREF(off);
                        PyErr_SetString(PyExc_TypeError, "bad utcoffset");
                        return nullptr;
                    }
                    off_us = ((int64_t)PyDateTime_DELTA_GET_DAYS(off) * 86400 +
                              PyDateTime_DELTA_GET_SECONDS(off)) *
                                 1000000 +
                             PyDateTime_DELTA_GET_MICROSECONDS(off);
                }
                Py_DECREF(off);
            }
            int64_t days = days_from_civil(PyDateTime_GET_YEAR(a0),
                                           PyDateTime_GET_MONTH(a0),
                                           PyDateTime_GET_DAY(a0));
            int64_t secs = (int64_t)PyDateTime_DATE_GET_HOUR(a0) * 3600 +
                           PyDateTime_DATE_GET_MINUTE(a0) * 60 +
                           PyDateTime_DATE_GET_SECOND(a0);
            int64_t us_total = (days * 86400 + secs) * 1000000 +
                               PyDateTime_DATE_GET_MICROSECOND(a0) - off_us;
            // (d - epoch).total_seconds() bit-exact: split into the
            // timedelta fields Python would hold, then its double formula
            int64_t td_days = us_total >= 0
                                  ? us_total / 86400000000LL
                                  : -((-us_total + 86399999999LL) /
                                      86400000000LL);
            int64_t rem_us = us_total - td_days * 86400000000LL;
            double ts = td_total_seconds(td_days, rem_us / 1000000,
                                         rem_us % 1000000);
            return PyFloat_FromDouble(ts * PyFloat_AS_DOUBLE(args[1]));
        }
        case M_DT_STRFTIME: {
            if (!PyUnicode_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "format must be str");
                return nullptr;
            }
            Py_ssize_t flen;
            const char* f = PyUnicode_AsUTF8AndSize(args[1], &flen);
            if (f == nullptr) return nullptr;
            std::string out;
            out.reserve((size_t)flen + 16);
            int rc = c_strftime(a0, f, flen, &out);
            if (rc < 0) return nullptr;
            if (rc == 0)
                return PyObject_CallMethod(a0, "strftime", "O", args[1]);
            return PyUnicode_FromStringAndSize(out.data(),
                                               (Py_ssize_t)out.size());
        }
        case M_DT_ROUND:
        case M_DT_FLOOR: {
            // replicate _round_dt/_floor_dt double math exactly
            if (!PyDateTime_Check(a0) || !PyDelta_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "expected datetime+duration");
                return nullptr;
            }
            PyObject* tzinfo = PyDateTime_DATE_GET_TZINFO(a0);
            double delta;
            PyObject* epoch = nullptr;  // aware path only
            if (tzinfo == Py_None) {
                int64_t days = days_from_civil(PyDateTime_GET_YEAR(a0),
                                               PyDateTime_GET_MONTH(a0),
                                               PyDateTime_GET_DAY(a0));
                int64_t secs =
                    (int64_t)PyDateTime_DATE_GET_HOUR(a0) * 3600 +
                    PyDateTime_DATE_GET_MINUTE(a0) * 60 +
                    PyDateTime_DATE_GET_SECOND(a0);
                delta = td_total_seconds(
                    days, secs, PyDateTime_DATE_GET_MICROSECOND(a0));
            } else {
                // aware: (d - epoch(tz)).total_seconds() must go through
                // the real subtraction — a zoneinfo tz can have different
                // utcoffsets at d and at the epoch
                epoch = PyDateTimeAPI->DateTime_FromDateAndTime(
                    1970, 1, 1, 0, 0, 0, 0, tzinfo,
                    PyDateTimeAPI->DateTimeType);
                if (epoch == nullptr) return nullptr;
                PyObject* diff = PyNumber_Subtract(a0, epoch);
                if (diff == nullptr || !PyDelta_Check(diff)) {
                    Py_XDECREF(diff);
                    Py_DECREF(epoch);
                    if (!PyErr_Occurred())
                        PyErr_SetString(PyExc_TypeError, "bad subtraction");
                    return nullptr;
                }
                delta = td_total_seconds(
                    PyDateTime_DELTA_GET_DAYS(diff),
                    PyDateTime_DELTA_GET_SECONDS(diff),
                    PyDateTime_DELTA_GET_MICROSECONDS(diff));
                Py_DECREF(diff);
            }
            double step =
                td_total_seconds(PyDateTime_DELTA_GET_DAYS(args[1]),
                                 PyDateTime_DELTA_GET_SECONDS(args[1]),
                                 PyDateTime_DELTA_GET_MICROSECONDS(args[1]));
            if (step == 0.0) {
                Py_XDECREF(epoch);
                PyErr_SetString(PyExc_ZeroDivisionError, "zero duration");
                return nullptr;
            }
            double q = delta / step;
            double steps = mid == M_DT_FLOOR ? std::floor(q)
                                             : std::nearbyint(q);
            double result_s = steps * step;
            // timedelta(seconds=result_s) microsecond rounding: integer
            // part exact, fractional part round-half-even (datetime.c
            // accum()/delta_new)
            double ipart;
            double fpart = std::modf(result_s, &ipart);
            if (!(ipart >= -9.0e15 && ipart <= 9.0e15)) {
                Py_XDECREF(epoch);
                PyErr_SetString(PyExc_OverflowError, "duration too large");
                return nullptr;
            }
            int64_t total_us = (int64_t)ipart * 1000000 +
                               (int64_t)std::nearbyint(fpart * 1e6);
            if (epoch != nullptr) {
                // aware: epoch + timedelta via the datetime type itself
                int64_t rdays = total_us >= 0
                                    ? total_us / 86400000000LL
                                    : -((-total_us + 86399999999LL) /
                                        86400000000LL);
                int64_t rem = total_us - rdays * 86400000000LL;
                PyObject* td = PyDelta_FromDSU(
                    (int)rdays, (int)(rem / 1000000), (int)(rem % 1000000));
                if (td == nullptr) {
                    Py_DECREF(epoch);
                    return nullptr;
                }
                PyObject* r = PyNumber_Add(epoch, td);
                Py_DECREF(td);
                Py_DECREF(epoch);
                return r;
            }
            int64_t rdays = total_us >= 0
                                ? total_us / 86400000000LL
                                : -((-total_us + 86399999999LL) /
                                    86400000000LL);
            int64_t rem = total_us - rdays * 86400000000LL;
            int64_t y, mo, dd;
            civil_from_days(rdays, &y, &mo, &dd);
            if (y < 1 || y > 9999) {
                PyErr_SetString(PyExc_OverflowError, "date out of range");
                return nullptr;
            }
            return PyDateTimeAPI->DateTime_FromDateAndTime(
                (int)y, (int)mo, (int)dd, (int)(rem / 3600000000LL),
                (int)(rem / 60000000 % 60), (int)(rem / 1000000 % 60),
                (int)(rem % 1000000), Py_None, PyDateTimeAPI->DateTimeType);
        }
        // ---- duration accessors -------------------------------------
        case M_DUR_NANOSECONDS:
        case M_DUR_MICROSECONDS:
        case M_DUR_MILLISECONDS:
        case M_DUR_SECONDS:
        case M_DUR_MINUTES:
        case M_DUR_HOURS:
        case M_DUR_DAYS:
        case M_DUR_WEEKS: {
            if (!PyDelta_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected duration");
                return nullptr;
            }
            int64_t days = PyDateTime_DELTA_GET_DAYS(a0);
            if (mid == M_DUR_DAYS) return PyLong_FromLongLong(days);
            if (mid == M_DUR_WEEKS) {
                int64_t w = days >= 0 ? days / 7 : -((-days + 6) / 7);
                return PyLong_FromLongLong(w);
            }
            double ts = td_total_seconds(days, PyDateTime_DELTA_GET_SECONDS(a0),
                                         PyDateTime_DELTA_GET_MICROSECONDS(a0));
            double scaled;
            switch (mid) {
                case M_DUR_NANOSECONDS: scaled = ts * 1e9; break;
                case M_DUR_MICROSECONDS: scaled = ts * 1e6; break;
                case M_DUR_MILLISECONDS: scaled = ts * 1e3; break;
                case M_DUR_SECONDS: scaled = ts; break;
                case M_DUR_MINUTES: scaled = std::floor(ts / 60.0); break;
                default: scaled = std::floor(ts / 3600.0); break;
            }
            // int(double): PyLong_FromDouble truncates toward zero and
            // handles magnitudes beyond int64 as a big int, exactly like
            // the closure's int(...)
            return PyLong_FromDouble(scaled);
        }
        // ---- num ----------------------------------------------------
        case M_NUM_ABS:
            return PyNumber_Absolute(a0);
        case M_NUM_FILL_NA: {
            PyObject* r = a0;
            if (a0 == Py_None ||
                (PyFloat_Check(a0) && std::isnan(PyFloat_AS_DOUBLE(a0))))
                r = args[1];
            Py_INCREF(r);
            return r;
        }
        case M_NUM_ROUND: {
            // round(x, d): d is always passed by the closure, so the
            // result keeps x's type (round(2.5, 0) == 2.0, not 2)
            PyObject* d = args[1];
            if (PyLong_CheckExact(d)) {
                long nd = PyLong_AsLong(d);
                if (nd == -1 && PyErr_Occurred()) {
                    PyErr_Clear();  // huge ndigits: defer to __round__
                } else if (PyLong_CheckExact(a0) && nd >= 0) {
                    Py_INCREF(a0);  // ndigits >= 0 keeps an exact int
                    return a0;
                } else if (PyFloat_CheckExact(a0) && nd == 0) {
                    // ties-to-even to an integral double — exactly
                    // float.__round__(0), incl. nan/inf passthrough
                    return PyFloat_FromDouble(
                        std::nearbyint(PyFloat_AS_DOUBLE(a0)));
                }
            }
            // decimal ndigits / bools / odd types: the type's __round__
            // (what builtin round(x, d) dispatches to); missing __round__
            // raises, which the caller maps to ERROR like the closure
            return PyObject_CallMethod(a0, "__round__", "O", d);
        }
        case M_STR_SPLIT: {
            // (s, maxsplit) = whitespace split; (s, sep, maxsplit) = by
            // separator — exactly str.split(None|sep, maxsplit), wrapped
            // to a tuple like the closure
            if (!PyUnicode_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected str");
                return nullptr;
            }
            PyObject* sep = nargs >= 3 ? args[1] : nullptr;
            if (sep != nullptr && !PyUnicode_Check(sep)) {
                PyErr_SetString(PyExc_TypeError, "sep must be str");
                return nullptr;
            }
            PyObject* ms = args[nargs - 1];
            if (!PyLong_Check(ms)) {
                PyErr_SetString(PyExc_TypeError, "maxsplit must be an int");
                return nullptr;
            }
            Py_ssize_t maxsplit = PyLong_AsSsize_t(ms);
            if (maxsplit == -1 && PyErr_Occurred()) return nullptr;
            PyObject* lst = PyUnicode_Split(a0, sep, maxsplit);
            if (lst == nullptr) return nullptr;  // empty sep: ValueError
            PyObject* tup = PyList_AsTuple(lst);
            Py_DECREF(lst);
            return tup;
        }
        case M_DT_FROM_TIMESTAMP:
        case M_DT_UTC_FROM_TIMESTAMP: {
            // (x, scale): datetime.fromtimestamp(x / scale, tz=utc)
            // [.replace(tzinfo=None) for the naive variant].  Replicates
            // CPython's conversion: modf split, fractional microseconds
            // rounded half-even (_PyTime_ROUND_HALF_EVEN), carry
            // normalized into [0, 1e6).
            double xv;
            if (PyFloat_Check(a0)) {
                xv = PyFloat_AS_DOUBLE(a0);
            } else if (PyLong_Check(a0)) {
                xv = PyLong_AsDouble(a0);
                if (xv == -1.0 && PyErr_Occurred()) return nullptr;
            } else {
                PyErr_SetString(PyExc_TypeError, "expected int|float");
                return nullptr;
            }
            if (!PyFloat_Check(args[1])) {
                PyErr_SetString(PyExc_TypeError, "scale must be float");
                return nullptr;
            }
            double t = xv / PyFloat_AS_DOUBLE(args[1]);
            // datetime covers years [1, 9999]; anything outside (incl.
            // nan/inf) raises like fromtimestamp does -> row ERROR
            if (!(t >= -62135596800.0 && t <= 253402300800.0)) {
                PyErr_SetString(PyExc_OverflowError,
                                "timestamp out of range");
                return nullptr;
            }
            double intpart;
            double usf = std::modf(t, &intpart) * 1e6;
            double rounded = std::round(usf);
            if (std::fabs(usf - rounded) == 0.5)
                rounded = 2.0 * std::round(usf / 2.0);
            int64_t secs = (int64_t)intpart;
            int64_t us = (int64_t)rounded;
            if (us >= 1000000) {
                us -= 1000000;
                secs += 1;
            } else if (us < 0) {
                us += 1000000;
                secs -= 1;
            }
            if (!ensure_datetime_cache()) return nullptr;
            return dt_from_epoch_us(
                secs * 1000000 + us,
                mid == M_DT_UTC_FROM_TIMESTAMP ? g_utc_singleton : Py_None,
                0);
        }
        case M_DT_TO_UTC:
        case M_DT_TO_NAIVE_TZ: {
            // (d, tz_table): zoneinfo conversions over the packed
            // transition tables (see TzTable above).  to_utc mirrors
            // ZoneInfo._find_trans over the local-side keys (lookup
            // ignores microseconds, like _get_local_timestamp);
            // to_naive_in_timezone mirrors ZoneInfo.fromutc over the
            // utc-side keys including its fold detection.
            PyObject* tbl = args[1];
            if (!PyTuple_Check(tbl) || (PyTuple_GET_SIZE(tbl) != 9 &&
                                        PyTuple_GET_SIZE(tbl) != 2)) {
                PyErr_SetString(PyExc_TypeError, "bad tz table");
                return nullptr;
            }
            PyObject* fallback =
                PyTuple_GET_ITEM(tbl, PyTuple_GET_SIZE(tbl) - 1);
            if (!PyDateTime_Check(a0)) {
                PyErr_SetString(PyExc_TypeError, "expected datetime");
                return nullptr;
            }
            PyObject* tzinfo = PyDateTime_DATE_GET_TZINFO(a0);
            bool to_utc = mid == M_DT_TO_UTC;
            if (PyTuple_GET_SIZE(tbl) == 2 ||
                (!to_utc && tzinfo == Py_None))  // naive astimezone =
                                                 // system-local: Python
                return PyObject_CallFunctionObjArgs(fallback, a0, nullptr);
            if (!ensure_datetime_cache()) return nullptr;
            TzTable T;
            if (!tz_table_view(tbl, &T)) return nullptr;
            int64_t days = days_from_civil(PyDateTime_GET_YEAR(a0),
                                           PyDateTime_GET_MONTH(a0),
                                           PyDateTime_GET_DAY(a0));
            int64_t fsecs = (int64_t)PyDateTime_DATE_GET_HOUR(a0) * 3600 +
                            PyDateTime_DATE_GET_MINUTE(a0) * 60 +
                            PyDateTime_DATE_GET_SECOND(a0);
            int64_t field_us = (days * 86400 + fsecs) * 1000000 +
                               PyDateTime_DATE_GET_MICROSECOND(a0);
            if (to_utc) {
                // wall fields -> aware UTC; input tzinfo (if any) is
                // discarded, exactly like d.replace(tzinfo=zone)
                int64_t ts = days * 86400 + fsecs;
                const int64_t* lk =
                    PyDateTime_DATE_GET_FOLD(a0) ? T.lk1 : T.lk0;
                int64_t off;
                if (T.n == 0 || ts > lk[T.n - 1]) {
                    if (!T.has_after)  // rule footer: per-value Python
                        return PyObject_CallFunctionObjArgs(fallback, a0,
                                                            nullptr);
                    off = T.after_off;
                } else if (ts < lk[0]) {
                    off = T.off_before;
                } else {
                    int64_t idx =
                        (int64_t)(std::upper_bound(lk, lk + T.n, ts) - lk) -
                        1;
                    off = T.offs[idx];
                }
                return dt_from_epoch_us(field_us - off * 1000000,
                                        g_utc_singleton, 0);
            }
            // to_naive_in_timezone: aware -> naive local wall time.
            // astimezone short-circuits when the input already carries
            // the SAME zone instance (fields kept verbatim).
            if (tzinfo == PyTuple_GET_ITEM(tbl, 7))
                return PyDateTimeAPI->DateTime_FromDateAndTimeAndFold(
                    PyDateTime_GET_YEAR(a0), PyDateTime_GET_MONTH(a0),
                    PyDateTime_GET_DAY(a0), PyDateTime_DATE_GET_HOUR(a0),
                    PyDateTime_DATE_GET_MINUTE(a0),
                    PyDateTime_DATE_GET_SECOND(a0),
                    PyDateTime_DATE_GET_MICROSECOND(a0), Py_None,
                    PyDateTime_DATE_GET_FOLD(a0),
                    PyDateTimeAPI->DateTimeType);
            // input offset via Python (arbitrary tzinfo), the
            // M_DT_TIMESTAMP pattern
            PyObject* off_o = PyObject_CallMethod(a0, "utcoffset", nullptr);
            if (off_o == nullptr) return nullptr;
            if (off_o == Py_None) {
                Py_DECREF(off_o);
                return PyObject_CallFunctionObjArgs(fallback, a0, nullptr);
            }
            if (!PyDelta_Check(off_o)) {
                Py_DECREF(off_o);
                PyErr_SetString(PyExc_TypeError, "bad utcoffset");
                return nullptr;
            }
            int64_t in_off_us =
                ((int64_t)PyDateTime_DELTA_GET_DAYS(off_o) * 86400 +
                 PyDateTime_DELTA_GET_SECONDS(off_o)) *
                    1000000 +
                PyDateTime_DELTA_GET_MICROSECONDS(off_o);
            Py_DECREF(off_o);
            int64_t utc_us = field_us - in_off_us;
            // fromutc's lookup key: civil seconds of the utc-labelled
            // datetime, i.e. floor(utc_us / 1e6)
            int64_t ts = utc_us >= 0 ? utc_us / 1000000
                                     : -((-utc_us + 999999) / 1000000);
            int64_t off;
            int fold = 0;
            if (T.n >= 1 && ts < T.trans_utc[0]) {
                off = T.off_before;
            } else if (T.n == 0 || ts > T.trans_utc[T.n - 1]) {
                // footer region: fixed-offset zones with no transitions
                // are native; rule footers / post-last-transition go to
                // Python (fromutc's corner branches)
                if (T.n == 0 && T.has_after)
                    off = T.after_off;
                else
                    return PyObject_CallFunctionObjArgs(fallback, a0,
                                                        nullptr);
            } else {
                int64_t idx = (int64_t)(std::upper_bound(
                                            T.trans_utc, T.trans_utc + T.n,
                                            ts) -
                                        T.trans_utc);  // >= 1
                off = T.offs[idx - 1];
                int64_t off_prev =
                    idx >= 2 ? T.offs[idx - 2] : T.off_before;
                fold = (off_prev - off) > (ts - T.trans_utc[idx - 1]) ? 1
                                                                      : 0;
            }
            return dt_from_epoch_us(utc_us + off * 1000000, Py_None, fold);
        }
        default:
            PyErr_Format(PyExc_SystemError, "bad method id %lld",
                         (long long)mid);
            return nullptr;
    }
}

enum VmOp : int64_t {
    VM_LOAD_COL = 1,    // (pos)            push values[pos]
    VM_LOAD_KEY = 2,    //                  push key
    VM_LOAD_CONST = 3,  // (idx)            push consts[idx]
    VM_CALL_PY = 4,     // (idx)            push pyfuncs[idx]((key, values))
    VM_BIN = 5,         // (binop)
    VM_NEG = 6,
    VM_INV = 7,
    VM_IS_NONE = 8,
    VM_BRANCH = 9,      // (else_t, end_t)  pop cond
    VM_JUMP = 10,       // (t)
    VM_JUMP_NOT_NONE = 11,  // (t)          peek
    VM_POP = 12,
    VM_REQUIRE = 13,    // (end_t)          pop; None -> push None, jump
    VM_UNWRAP = 14,     //                  pop; None -> ERROR
    VM_FILL_JUMP = 15,  // (t)              peek; not ERROR -> jump
    VM_CAST = 16,       // (tid)            0 int 1 float 2 bool 3 str
    VM_CONVERT = 17,    // (tid, unwrap)    Json-aware strict conversion
    VM_MAKE_TUPLE = 18, // (n)
    VM_GET = 19,        // (strict, end_t)  pop idx, obj
    VM_POINTER = 20,    // (n, opt, rs_idx) pop n args -> Pointer key
    VM_METHOD = 21,     // (mid, nargs, propagate_none) namespace method
};

enum VmBin : int64_t {
    B_ADD = 0, B_SUB, B_MUL, B_TRUEDIV, B_FLOORDIV, B_MOD, B_POW,
    B_MATMUL, B_EQ, B_NE, B_LT, B_LE, B_GT, B_GE, B_AND, B_OR, B_XOR,
};

struct VmProgram {
    std::vector<int64_t> code;
    std::vector<PyObject*> consts;   // owned
    std::vector<PyObject*> pyfuncs;  // owned
    size_t max_stack = 0;
    ~VmProgram() {
        for (auto* o : consts) Py_XDECREF(o);
        for (auto* o : pyfuncs) Py_XDECREF(o);
    }
};

void vm_capsule_free(PyObject* cap) {
    delete static_cast<VmProgram*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.vm"));
}

// operand count per opcode; -1 = invalid
inline int vm_n_operands(int64_t op) {
    switch (op) {
        case VM_LOAD_KEY: case VM_NEG: case VM_INV: case VM_IS_NONE:
        case VM_POP: case VM_UNWRAP:
            return 0;
        case VM_LOAD_COL: case VM_LOAD_CONST: case VM_CALL_PY: case VM_BIN:
        case VM_JUMP: case VM_JUMP_NOT_NONE: case VM_REQUIRE:
        case VM_FILL_JUMP: case VM_CAST: case VM_MAKE_TUPLE:
            return 1;
        case VM_BRANCH: case VM_CONVERT: case VM_GET:
            return 2;
        case VM_POINTER: case VM_METHOD:
            return 3;
        default:
            return -1;
    }
}

// "simple" builtin scalar: known-sane __eq__, so the None shortcut in
// binary ops cannot diverge from Python (e.g. ndarray == None is
// elementwise and must go through the generic object path)
inline bool vm_is_simple(PyObject* v) {
    return v == Py_None || PyLong_Check(v) || PyFloat_Check(v) ||
           PyUnicode_Check(v) || PyBytes_Check(v) || PyTuple_Check(v);
}

// generic binary op with the Python-closure exception mapping.
// Returns a new reference; nullptr = row-level error (exception set).
PyObject* vm_bin_generic(int64_t op, PyObject* a, PyObject* b,
                         PyObject* error_obj) {
    if ((a == Py_None && vm_is_simple(b)) ||
        (b == Py_None && vm_is_simple(a))) {
        // TypeError-with-None outcome, without paying for the exception
        if (op == B_EQ) return PyBool_FromLong(a == b);
        if (op == B_NE) return PyBool_FromLong(a != b);
        Py_RETURN_NONE;
    }
    PyObject* r = nullptr;
    switch (op) {
        case B_ADD: r = PyNumber_Add(a, b); break;
        case B_SUB: r = PyNumber_Subtract(a, b); break;
        case B_MUL: r = PyNumber_Multiply(a, b); break;
        case B_TRUEDIV: r = PyNumber_TrueDivide(a, b); break;
        case B_FLOORDIV: r = PyNumber_FloorDivide(a, b); break;
        case B_MOD: r = PyNumber_Remainder(a, b); break;
        case B_POW: r = PyNumber_Power(a, b, Py_None); break;
        case B_MATMUL: r = PyNumber_MatrixMultiply(a, b); break;
        case B_EQ: r = PyObject_RichCompare(a, b, Py_EQ); break;
        case B_NE: r = PyObject_RichCompare(a, b, Py_NE); break;
        case B_LT: r = PyObject_RichCompare(a, b, Py_LT); break;
        case B_LE: r = PyObject_RichCompare(a, b, Py_LE); break;
        case B_GT: r = PyObject_RichCompare(a, b, Py_GT); break;
        case B_GE: r = PyObject_RichCompare(a, b, Py_GE); break;
        case B_AND: r = PyNumber_And(a, b); break;
        case B_OR: r = PyNumber_Or(a, b); break;
        case B_XOR: r = PyNumber_Xor(a, b); break;
        default:
            PyErr_SetString(PyExc_SystemError, "bad binop");
            return nullptr;
    }
    if (r != nullptr) return r;
    if (PyErr_ExceptionMatches(PyExc_TypeError)) {
        PyErr_Clear();
        if (a == Py_None || b == Py_None) {
            if (op == B_EQ) return PyBool_FromLong(a == b);
            if (op == B_NE) return PyBool_FromLong(a != b);
            Py_RETURN_NONE;
        }
        Py_INCREF(error_obj);
        return error_obj;
    }
    if (PyErr_ExceptionMatches(PyExc_ZeroDivisionError) ||
        PyErr_ExceptionMatches(PyExc_ValueError) ||
        PyErr_ExceptionMatches(PyExc_OverflowError)) {
        PyErr_Clear();
        Py_INCREF(error_obj);
        return error_obj;
    }
    return nullptr;  // row-level error
}

// fast paths for exact int/float/bool operands; nullptr with NO exception
// set means "no fast path, use generic"
PyObject* vm_bin_fast(int64_t op, PyObject* a, PyObject* b,
                      PyObject* error_obj) {
    if (PyLong_CheckExact(a) && PyLong_CheckExact(b)) {
        int oa = 0, ob = 0;
        long long av = PyLong_AsLongLongAndOverflow(a, &oa);
        long long bv = PyLong_AsLongLongAndOverflow(b, &ob);
        if (oa != 0 || ob != 0) return nullptr;  // big ints: generic
        long long res;
        switch (op) {
            case B_ADD:
                if (!__builtin_add_overflow(av, bv, &res))
                    return PyLong_FromLongLong(res);
                return nullptr;
            case B_SUB:
                if (!__builtin_sub_overflow(av, bv, &res))
                    return PyLong_FromLongLong(res);
                return nullptr;
            case B_MUL:
                if (!__builtin_mul_overflow(av, bv, &res))
                    return PyLong_FromLongLong(res);
                return nullptr;
            case B_FLOORDIV:
            case B_MOD: {
                if (bv == 0) {  // ZeroDivisionError -> ERROR
                    Py_INCREF(error_obj);
                    return error_obj;
                }
                if (av == LLONG_MIN && bv == -1) return nullptr;
                long long q = av / bv, m = av % bv;
                if (m != 0 && ((m < 0) != (bv < 0))) {  // Python floor rules
                    q -= 1;
                    m += bv;
                }
                return PyLong_FromLongLong(op == B_FLOORDIV ? q : m);
            }
            case B_EQ: return PyBool_FromLong(av == bv);
            case B_NE: return PyBool_FromLong(av != bv);
            case B_LT: return PyBool_FromLong(av < bv);
            case B_LE: return PyBool_FromLong(av <= bv);
            case B_GT: return PyBool_FromLong(av > bv);
            case B_GE: return PyBool_FromLong(av >= bv);
            case B_AND: return PyLong_FromLongLong(av & bv);
            case B_OR: return PyLong_FromLongLong(av | bv);
            case B_XOR: return PyLong_FromLongLong(av ^ bv);
            default: return nullptr;  // truediv/pow/matmul: generic
        }
    }
    if (PyFloat_CheckExact(a) && PyFloat_CheckExact(b)) {
        double av = PyFloat_AS_DOUBLE(a), bv = PyFloat_AS_DOUBLE(b);
        switch (op) {
            case B_ADD: return PyFloat_FromDouble(av + bv);
            case B_SUB: return PyFloat_FromDouble(av - bv);
            case B_MUL: return PyFloat_FromDouble(av * bv);
            case B_TRUEDIV:
                if (bv == 0.0) {  // Python float/0.0 raises -> ERROR
                    Py_INCREF(error_obj);
                    return error_obj;
                }
                return PyFloat_FromDouble(av / bv);
            case B_EQ: return PyBool_FromLong(av == bv);
            case B_NE: return PyBool_FromLong(av != bv);
            case B_LT: return PyBool_FromLong(av < bv);
            case B_LE: return PyBool_FromLong(av <= bv);
            case B_GT: return PyBool_FromLong(av > bv);
            case B_GE: return PyBool_FromLong(av >= bv);
            default: return nullptr;  // //,%: sign rules differ -> generic
        }
    }
    if (PyBool_Check(a) && PyBool_Check(b)) {
        switch (op) {
            case B_AND: return PyBool_FromLong(a == Py_True && b == Py_True);
            case B_OR: return PyBool_FromLong(a == Py_True || b == Py_True);
            case B_XOR: return PyBool_FromLong((a == Py_True) != (b == Py_True));
            case B_EQ: return PyBool_FromLong(a == b);
            case B_NE: return PyBool_FromLong(a != b);
            default: return nullptr;
        }
    }
    return nullptr;
}

// Evaluate one program over one row.  Returns a new reference, or
// nullptr with a Python exception set (row-level error; batch loop
// contains it).  kv_cache: lazily built (key, values) tuple shared by
// every CALL_PY of this row across programs.
PyObject* vm_eval(VmProgram* P, PyObject* key, PyObject* values,
                  PyObject* error_obj, PyObject** kv_cache,
                  std::vector<PyObject*>& stack) {
    const int64_t* code = P->code.data();
    const size_t nc = P->code.size();
    size_t sp = 0, ip = 0;
    while (ip < nc) {
        int64_t op = code[ip++];
        switch (op) {
            case VM_LOAD_COL: {
                int64_t pos = code[ip++];
                if (!PyTuple_Check(values) ||
                    pos >= PyTuple_GET_SIZE(values)) {
                    PyErr_SetString(PyExc_IndexError, "row too short");
                    goto rowfail;
                }
                PyObject* v = PyTuple_GET_ITEM(values, pos);
                Py_INCREF(v);
                stack[sp++] = v;
                break;
            }
            case VM_LOAD_KEY:
                Py_INCREF(key);
                stack[sp++] = key;
                break;
            case VM_LOAD_CONST: {
                PyObject* v = P->consts[code[ip++]];
                Py_INCREF(v);
                stack[sp++] = v;
                break;
            }
            case VM_CALL_PY: {
                if (*kv_cache == nullptr) {
                    *kv_cache = PyTuple_Pack(2, key, values);
                    if (*kv_cache == nullptr) goto rowfail;
                }
                PyObject* r =
                    PyObject_CallOneArg(P->pyfuncs[code[ip++]], *kv_cache);
                if (r == nullptr) goto rowfail;
                stack[sp++] = r;
                break;
            }
            case VM_BIN: {
                int64_t bop = code[ip++];
                PyObject* b = stack[--sp];
                PyObject* a = stack[--sp];
                PyObject* r;
                if (a == error_obj || b == error_obj) {
                    Py_INCREF(error_obj);
                    r = error_obj;
                } else {
                    r = vm_bin_fast(bop, a, b, error_obj);
                    if (r == nullptr && !PyErr_Occurred())
                        r = vm_bin_generic(bop, a, b, error_obj);
                }
                Py_DECREF(a);
                Py_DECREF(b);
                if (r == nullptr) goto rowfail;
                stack[sp++] = r;
                break;
            }
            case VM_NEG:
            case VM_INV: {
                PyObject* v = stack[sp - 1];
                if (v == error_obj || v == Py_None) break;  // pass through
                PyObject* r;
                if (op == VM_INV && PyBool_Check(v)) {
                    r = PyBool_FromLong(v == Py_False);
                } else {
                    r = op == VM_NEG ? PyNumber_Negative(v)
                                     : PyNumber_Invert(v);
                    if (r == nullptr) {
                        if (!PyErr_ExceptionMatches(PyExc_TypeError))
                            goto rowfail;
                        PyErr_Clear();
                        Py_INCREF(error_obj);
                        r = error_obj;
                    }
                }
                Py_DECREF(v);
                stack[sp - 1] = r;
                break;
            }
            case VM_IS_NONE: {
                PyObject* v = stack[sp - 1];
                if (v == error_obj) break;
                PyObject* r = PyBool_FromLong(v == Py_None);
                Py_DECREF(v);
                stack[sp - 1] = r;
                break;
            }
            case VM_BRANCH: {
                int64_t else_t = code[ip], end_t = code[ip + 1];
                ip += 2;
                PyObject* c = stack[--sp];
                if (c == error_obj) {
                    stack[sp++] = c;  // keep the ref, reuse as result
                    ip = (size_t)end_t;
                    break;
                }
                int t = PyObject_IsTrue(c);
                Py_DECREF(c);
                if (t < 0) goto rowfail;
                if (!t) ip = (size_t)else_t;
                break;
            }
            case VM_JUMP:
                ip = (size_t)code[ip];
                break;
            case VM_JUMP_NOT_NONE: {
                int64_t t = code[ip++];
                if (stack[sp - 1] != Py_None) ip = (size_t)t;
                break;
            }
            case VM_POP:
                Py_DECREF(stack[--sp]);
                break;
            case VM_REQUIRE: {
                int64_t end_t = code[ip++];
                PyObject* v = stack[--sp];
                if (v == Py_None) {
                    stack[sp++] = v;  // None is the result
                    ip = (size_t)end_t;
                } else {
                    Py_DECREF(v);
                }
                break;
            }
            case VM_UNWRAP: {
                PyObject* v = stack[sp - 1];
                if (v == Py_None) {
                    Py_DECREF(v);
                    Py_INCREF(error_obj);
                    stack[sp - 1] = error_obj;
                }
                break;
            }
            case VM_FILL_JUMP: {
                int64_t t = code[ip++];
                if (stack[sp - 1] != error_obj) ip = (size_t)t;
                break;
            }
            case VM_CAST: {
                int64_t tid = code[ip++];
                PyObject* v = stack[sp - 1];
                if (v == error_obj || v == Py_None) break;
                PyObject* r = nullptr;
                switch (tid) {
                    case 0: r = PyNumber_Long(v); break;
                    case 1: r = PyNumber_Float(v); break;
                    case 2: {
                        int t = PyObject_IsTrue(v);
                        if (t >= 0) r = PyBool_FromLong(t);
                        break;
                    }
                    case 3: r = PyObject_Str(v); break;
                }
                if (r == nullptr) {
                    if (!PyErr_ExceptionMatches(PyExc_ValueError) &&
                        !PyErr_ExceptionMatches(PyExc_TypeError))
                        goto rowfail;
                    PyErr_Clear();
                    Py_INCREF(error_obj);
                    r = error_obj;
                }
                Py_DECREF(v);
                stack[sp - 1] = r;
                break;
            }
            case VM_CONVERT: {
                int64_t tid = code[ip], unwrap = code[ip + 1];
                ip += 2;
                PyObject* v = stack[sp - 1];
                if (v == error_obj) break;
                // Json unboxes to its .value first
                if (g_json_type != nullptr &&
                    PyObject_TypeCheck(
                        v, reinterpret_cast<PyTypeObject*>(g_json_type))) {
                    PyObject* inner = PyObject_GetAttrString(v, "value");
                    if (inner == nullptr) goto rowfail;
                    Py_DECREF(v);
                    v = stack[sp - 1] = inner;
                }
                if (v == Py_None) {
                    if (unwrap) {
                        Py_DECREF(v);
                        Py_INCREF(error_obj);
                        stack[sp - 1] = error_obj;
                    }
                    break;
                }
                PyObject* r = nullptr;
                bool type_ok;
                switch (tid) {
                    case 0:  // int: bool and non-numbers are ERROR
                    case 1:  // float
                        type_ok = !PyBool_Check(v) &&
                                  (PyLong_Check(v) || PyFloat_Check(v));
                        if (type_ok)
                            r = tid == 0 ? PyNumber_Long(v)
                                         : PyNumber_Float(v);
                        break;
                    case 2:
                        type_ok = PyBool_Check(v);
                        if (type_ok) {
                            Py_INCREF(v);
                            r = v;
                        }
                        break;
                    default:
                        type_ok = PyUnicode_Check(v);
                        if (type_ok) {
                            Py_INCREF(v);
                            r = v;
                        }
                        break;
                }
                if (r == nullptr) {
                    if (PyErr_Occurred()) {
                        if (!PyErr_ExceptionMatches(PyExc_ValueError) &&
                            !PyErr_ExceptionMatches(PyExc_TypeError))
                            goto rowfail;
                        PyErr_Clear();
                    }
                    Py_INCREF(error_obj);
                    r = error_obj;
                }
                Py_DECREF(v);
                stack[sp - 1] = r;
                break;
            }
            case VM_MAKE_TUPLE: {
                int64_t n = code[ip++];
                PyObject* t = PyTuple_New(n);
                if (t == nullptr) goto rowfail;
                for (int64_t j = n - 1; j >= 0; j--)
                    PyTuple_SET_ITEM(t, j, stack[--sp]);  // steals refs
                stack[sp++] = t;
                break;
            }
            case VM_GET: {
                int64_t strict = code[ip], end_t = code[ip + 1];
                ip += 2;
                PyObject* idx = stack[--sp];
                PyObject* obj = stack[--sp];
                if (obj == error_obj || idx == error_obj) {
                    Py_DECREF(obj);
                    Py_DECREF(idx);
                    Py_INCREF(error_obj);
                    stack[sp++] = error_obj;
                    ip = (size_t)end_t;
                    break;
                }
                PyObject* v = nullptr;
                bool is_json =
                    g_json_type != nullptr &&
                    PyObject_TypeCheck(
                        obj, reinterpret_cast<PyTypeObject*>(g_json_type));
                if (is_json) {
                    PyObject* inner = PyObject_GetAttrString(obj, "value");
                    if (inner == nullptr) {
                        Py_DECREF(obj);
                        Py_DECREF(idx);
                        goto rowfail;
                    }
                    v = PyObject_GetItem(inner, idx);
                    Py_DECREF(inner);
                    if (v != nullptr &&
                        !PyObject_TypeCheck(
                            v, reinterpret_cast<PyTypeObject*>(g_json_type))) {
                        // Json getitem re-wraps plain values as Json
                        PyObject* wrapped = PyObject_CallFunctionObjArgs(
                            g_json_type, v, nullptr);
                        Py_DECREF(v);
                        v = wrapped;
                        if (v == nullptr) {
                            Py_DECREF(obj);
                            Py_DECREF(idx);
                            goto rowfail;
                        }
                    }
                } else {
                    v = PyObject_GetItem(obj, idx);
                }
                Py_DECREF(obj);
                Py_DECREF(idx);
                if (v != nullptr) {
                    stack[sp++] = v;
                    ip = (size_t)end_t;
                    break;
                }
                if (!PyErr_ExceptionMatches(PyExc_KeyError) &&
                    !PyErr_ExceptionMatches(PyExc_IndexError) &&
                    !PyErr_ExceptionMatches(PyExc_TypeError))
                    goto rowfail;
                PyErr_Clear();
                if (strict) {
                    Py_INCREF(error_obj);
                    stack[sp++] = error_obj;
                    ip = (size_t)end_t;
                }
                // non-strict: fall through into the default's code
                break;
            }
            case VM_POINTER: {
                int64_t n = code[ip], opt = code[ip + 1],
                        rs_idx = code[ip + 2];
                ip += 3;
                PyObject** base = &stack[sp - n];
                if (opt) {
                    bool any_none = false;
                    for (int64_t j = 0; j < n; j++)
                        if (base[j] == Py_None) any_none = true;
                    if (any_none) {
                        for (int64_t j = 0; j < n; j++) Py_DECREF(base[j]);
                        sp -= (size_t)n;
                        Py_INCREF(Py_None);
                        stack[sp++] = Py_None;
                        break;
                    }
                }
                Hasher h;
                bool ok = g_pointer_type != nullptr;
                for (int64_t j = 0; j < n && ok; j++) ok = feed(h, base[j]);
                PyObject* r = nullptr;
                if (ok) {
                    PyObject* num = digest_to_long(h);
                    if (num == nullptr) goto rowfail_ptr;
                    r = pointer_from_long(num);
                } else {
                    if (PyErr_Occurred()) PyErr_Clear();
                    // unsupported value type: defer to Python ref_scalar
                    PyObject* t = PyTuple_New(n);
                    if (t == nullptr) goto rowfail_ptr;
                    for (int64_t j = 0; j < n; j++) {
                        Py_INCREF(base[j]);
                        PyTuple_SET_ITEM(t, j, base[j]);
                    }
                    r = PyObject_Call(P->consts[rs_idx], t, nullptr);
                    Py_DECREF(t);
                }
                if (r == nullptr) goto rowfail_ptr;
                for (int64_t j = 0; j < n; j++) Py_DECREF(base[j]);
                sp -= (size_t)n;
                stack[sp++] = r;
                break;
            rowfail_ptr:
                goto rowfail;
            }
            case VM_METHOD: {
                int64_t mid = code[ip], n = code[ip + 1],
                        prop_none = code[ip + 2];
                ip += 3;
                PyObject** base = &stack[sp - n];
                // closure contract (MethodCallExpression._compile run()):
                // any ERROR arg -> ERROR; any None arg -> None when the
                // method propagates None; an exception -> ERROR
                bool any_err = false, any_none = false;
                for (int64_t j = 0; j < n; j++) {
                    if (base[j] == error_obj) any_err = true;
                    if (base[j] == Py_None) any_none = true;
                }
                PyObject* r;
                if (any_err) {
                    Py_INCREF(error_obj);
                    r = error_obj;
                } else if (prop_none && any_none) {
                    Py_INCREF(Py_None);
                    r = Py_None;
                } else {
                    r = vm_method_eval(mid, base, n);
                    if (r == nullptr) {
                        if (PyErr_ExceptionMatches(PyExc_SystemError) ||
                            PyErr_ExceptionMatches(PyExc_MemoryError))
                            goto rowfail;
                        PyErr_Clear();
                        Py_INCREF(error_obj);
                        r = error_obj;
                    }
                }
                for (int64_t j = 0; j < n; j++) Py_DECREF(base[j]);
                sp -= (size_t)n;
                stack[sp++] = r;
                break;
            }
            default:
                PyErr_SetString(PyExc_SystemError, "bad VM opcode");
                goto rowfail;
        }
    }
    if (sp != 1) {
        PyErr_SetString(PyExc_SystemError, "VM stack imbalance");
        goto rowfail;
    }
    return stack[0];
rowfail:
    while (sp > 0) Py_DECREF(stack[--sp]);
    return nullptr;
}

PyObject* py_vm_compile(PyObject*, PyObject* args) {
    // (code_seq[int], consts_seq, pyfuncs_seq) -> capsule
    PyObject *code_obj, *consts_obj, *pyfuncs_obj;
    if (!PyArg_ParseTuple(args, "OOO", &code_obj, &consts_obj, &pyfuncs_obj))
        return nullptr;
    PyObject* code_seq = PySequence_Fast(code_obj, "code must be a sequence");
    if (code_seq == nullptr) return nullptr;
    auto P = std::make_unique<VmProgram>();
    Py_ssize_t nc = PySequence_Fast_GET_SIZE(code_seq);
    P->code.reserve((size_t)nc);
    for (Py_ssize_t i = 0; i < nc; i++) {
        long long v =
            PyLong_AsLongLong(PySequence_Fast_GET_ITEM(code_seq, i));
        if (v == -1 && PyErr_Occurred()) {
            Py_DECREF(code_seq);
            return nullptr;
        }
        P->code.push_back(v);
    }
    Py_DECREF(code_seq);
    PyObject* cseq = PySequence_Fast(consts_obj, "consts must be a sequence");
    if (cseq == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(cseq); i++) {
        PyObject* o = PySequence_Fast_GET_ITEM(cseq, i);
        Py_INCREF(o);
        P->consts.push_back(o);
    }
    Py_DECREF(cseq);
    PyObject* fseq =
        PySequence_Fast(pyfuncs_obj, "pyfuncs must be a sequence");
    if (fseq == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(fseq); i++) {
        PyObject* o = PySequence_Fast_GET_ITEM(fseq, i);
        Py_INCREF(o);
        P->pyfuncs.push_back(o);
    }
    Py_DECREF(fseq);
    // Validation pass: operand counts, jump targets (instruction
    // boundaries only), table indices, AND full stack discipline — a
    // worklist dataflow over (ip -> stack depth).  The VM itself trusts
    // the program completely, so this is the only guard against stack
    // underflow / imbalance from a buggy or hostile lowering.
    {
        const size_t n = P->code.size();
        // instruction boundaries
        std::vector<uint8_t> is_insn(n + 1, 0);
        size_t ip = 0;
        while (ip < n) {
            is_insn[ip] = 1;
            int64_t op = P->code[ip];
            int nops = vm_n_operands(op);
            if (nops < 0 || ip + 1 + (size_t)nops > n) {
                PyErr_SetString(PyExc_ValueError, "malformed VM program");
                return nullptr;
            }
            ip += 1 + (size_t)nops;
        }
        is_insn[n] = 1;  // falling off the end is the exit
        std::vector<int> depth_at(n + 1, -1);  // -1 = unvisited
        std::vector<size_t> work;
        auto fail = [&]() {
            PyErr_SetString(PyExc_ValueError, "malformed VM program");
        };
        auto flow = [&](size_t target, int depth) -> bool {
            if (target > n || !is_insn[target]) return false;
            if (target == n && depth != 1) return false;  // exit depth
            if (depth_at[target] == -1) {
                depth_at[target] = depth;
                if (target < n) work.push_back(target);
                return true;
            }
            return depth_at[target] == depth;  // merge must agree
        };
        if (!flow(0, 0)) {
            fail();
            return nullptr;
        }
        size_t max_depth = 1;
        while (!work.empty()) {
            size_t at = work.back();
            work.pop_back();
            int64_t op = P->code[at];
            const int64_t* o = &P->code[at + 1];
            int d = depth_at[at];
            size_t next = at + 1 + (size_t)vm_n_operands(op);
            bool ok = true;
            int nd = d;
            switch (op) {
                case VM_LOAD_COL:
                    ok = o[0] >= 0 && flow(next, d + 1);
                    nd = d + 1;
                    break;
                case VM_LOAD_KEY:
                    ok = flow(next, d + 1);
                    nd = d + 1;
                    break;
                case VM_LOAD_CONST:
                    ok = o[0] >= 0 && (size_t)o[0] < P->consts.size() &&
                         flow(next, d + 1);
                    nd = d + 1;
                    break;
                case VM_CALL_PY:
                    ok = o[0] >= 0 && (size_t)o[0] < P->pyfuncs.size() &&
                         flow(next, d + 1);
                    nd = d + 1;
                    break;
                case VM_BIN:
                    ok = o[0] >= 0 && o[0] <= B_XOR && d >= 2 &&
                         flow(next, d - 1);
                    break;
                case VM_NEG:
                case VM_INV:
                case VM_IS_NONE:
                case VM_UNWRAP:
                    ok = d >= 1 && flow(next, d);
                    break;
                case VM_CAST:
                    ok = o[0] >= 0 && o[0] <= 3 && d >= 1 && flow(next, d);
                    break;
                case VM_CONVERT:
                    ok = o[0] >= 0 && o[0] <= 3 && d >= 1 && flow(next, d);
                    break;
                case VM_BRANCH:
                    // pop cond; ERROR path pushes and jumps to end
                    ok = d >= 1 && flow(next, d - 1) &&
                         flow((size_t)o[0], d - 1) && flow((size_t)o[1], d);
                    break;
                case VM_JUMP:
                    ok = flow((size_t)o[0], d);
                    break;
                case VM_JUMP_NOT_NONE:
                case VM_FILL_JUMP:
                    ok = d >= 1 && flow(next, d) && flow((size_t)o[0], d);
                    break;
                case VM_POP:
                    ok = d >= 1 && flow(next, d - 1);
                    break;
                case VM_REQUIRE:
                    // pop; None path re-pushes and jumps to end
                    ok = d >= 1 && flow(next, d - 1) && flow((size_t)o[0], d);
                    break;
                case VM_MAKE_TUPLE:
                    // full int64 comparison: a truncated (int) cast would
                    // let counts like 2^32+2 slip past and underflow the
                    // runtime stack
                    ok = o[0] >= 0 && (int64_t)d >= o[0] &&
                         flow(next, d - (int)o[0] + 1);
                    nd = d - (int)o[0] + 1;
                    break;
                case VM_GET:
                    // pops obj+idx; success/ERROR jump to end with +1
                    ok = d >= 2 && flow((size_t)o[1], d - 1) &&
                         (o[0] != 0 || flow(next, d - 2));
                    break;
                case VM_POINTER:
                    ok = o[0] >= 1 && (int64_t)d >= o[0] && o[2] >= 0 &&
                         (size_t)o[2] < P->consts.size() &&
                         flow(next, d - (int)o[0] + 1);
                    nd = d - (int)o[0] + 1;
                    break;
                case VM_METHOD:
                    ok = o[0] >= 0 && o[0] < M_METHOD_COUNT && o[1] >= 1 &&
                         o[1] <= 8 && (int64_t)d >= o[1] &&
                         flow(next, d - (int)o[1] + 1);
                    nd = d - (int)o[1] + 1;
                    break;
                default:
                    ok = false;
            }
            if (!ok) {
                fail();
                return nullptr;
            }
            if ((size_t)(nd + 1) > max_depth) max_depth = (size_t)(nd + 1);
        }
        P->max_stack = max_depth + 2;
    }
    PyObject* cap =
        PyCapsule_New(P.release(), "pathway_tpu.vm", vm_capsule_free);
    return cap;
}

inline VmProgram* vm_from_capsule(PyObject* cap) {
    return static_cast<VmProgram*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.vm"));
}

PyObject* py_vm_eval_batch(PyObject*, PyObject* args) {
    // (batch, progs_seq, update_cls, error_obj, on_error) -> list[Update]
    // Multi-column select: each program computes one output column; a
    // row whose evaluation raises becomes (ERROR,) after on_error(exc),
    // exactly like rowwise_map.
    PyObject *batch, *progs_obj, *update_cls, *error_obj, *on_error;
    if (!PyArg_ParseTuple(args, "OOOOO", &batch, &progs_obj, &update_cls,
                          &error_obj, &on_error))
        return nullptr;
    PyObject* progs =
        PySequence_Fast(progs_obj, "programs must be a sequence");
    if (progs == nullptr) return nullptr;
    Py_ssize_t np = PySequence_Fast_GET_SIZE(progs);
    std::vector<VmProgram*> P((size_t)np);
    size_t max_stack = 4;
    for (Py_ssize_t j = 0; j < np; j++) {
        P[(size_t)j] = vm_from_capsule(PySequence_Fast_GET_ITEM(progs, j));
        if (P[(size_t)j] == nullptr) {
            Py_DECREF(progs);
            return nullptr;
        }
        max_stack = std::max(max_stack, P[(size_t)j]->max_stack);
    }
    PyObject* seq = PySequence_Fast(batch, "vm_eval_batch expects a sequence");
    if (seq == nullptr) {
        Py_DECREF(progs);
        return nullptr;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) {
        Py_DECREF(seq);
        Py_DECREF(progs);
        return nullptr;
    }
    std::vector<PyObject*> stack(max_stack);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* key = PyTuple_GET_ITEM(u, 0);
            PyObject* values = PyTuple_GET_ITEM(u, 1);
            PyObject* diff = PyTuple_GET_ITEM(u, 2);
            PyObject* kv = nullptr;
            PyObject* vals = PyTuple_New(np);
            if (vals == nullptr) goto fail;
            for (Py_ssize_t j = 0; j < np; j++) {
                PyObject* v = vm_eval(P[(size_t)j], key, values, error_obj,
                                      &kv, stack);
                if (v == nullptr) {
                    Py_DECREF(vals);
                    vals = nullptr;
                    // row containment: Exception -> on_error + (ERROR,)
                    if (!PyErr_ExceptionMatches(PyExc_Exception)) {
                        Py_XDECREF(kv);
                        goto fail;
                    }
                    PyObject *etype, *evalue, *etb;
                    PyErr_Fetch(&etype, &evalue, &etb);
                    PyErr_NormalizeException(&etype, &evalue, &etb);
                    PyObject* r = PyObject_CallFunctionObjArgs(
                        on_error, evalue ? evalue : Py_None, nullptr);
                    Py_XDECREF(etype);
                    Py_XDECREF(evalue);
                    Py_XDECREF(etb);
                    if (r == nullptr) {
                        Py_XDECREF(kv);
                        goto fail;
                    }
                    Py_DECREF(r);
                    vals = PyTuple_Pack(1, error_obj);
                    if (vals == nullptr) {
                        Py_XDECREF(kv);
                        goto fail;
                    }
                    break;
                }
                PyTuple_SET_ITEM(vals, j, v);
            }
            Py_XDECREF(kv);
            PyObject* nu = make_update_obj(update_cls, key, vals, diff);
            Py_DECREF(vals);
            if (nu == nullptr) goto fail;
            PyList_SET_ITEM(out, i, nu);
        }
    }
    Py_DECREF(seq);
    Py_DECREF(progs);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(progs);
    Py_DECREF(out);
    return nullptr;
}

// ===========================================================================
// Native hash-join epoch pass
//
// The whole JoinNode.process hot loop (engine/graph.py JoinNode) in one
// C call, mirroring the reference's join arrangement machinery
// (src/engine/dataflow.rs join_tables): evaluate join keys via VM
// programs, snapshot old per-key output blocks, apply both deltas to the
// (Python-dict) arrangements, rebuild dirty blocks and emit the diff.
// State stays plain Python dicts {jk: {row_key: values}} so operator
// snapshots/resume and the Python fallback interoperate bit-for-bit.
//
// Any pre-mutation obstacle (unhashable join key, VM row error) raises
// Unsupported so the caller reruns the batch in Python; obstacles after
// mutation would desync state and therefore hard-fail instead — they
// cannot occur for values the VM produced (jk tuples are hashable by
// construction once PyObject_Hash succeeded).

// okey = ref_scalar("__join__", int(lk), int(rk)|None) — keys.join_key
PyObject* join_okey(PyObject* lk, PyObject* rk) {
    Hasher h;
    static const char kJ[] = "__join__";
    h.tag(0x04);
    h.u64le(sizeof(kJ) - 1);
    h.bytes(kJ, sizeof(kJ) - 1);
    if (!feed_pylong_plain(h, lk)) return nullptr;
    if (rk == Py_None || rk == nullptr) {
        h.tag(0x00);
    } else if (!feed_pylong_plain(h, rk)) {
        return nullptr;
    }
    PyObject* num = digest_to_long(h);
    if (num == nullptr) return nullptr;
    return pointer_from_long(num);
}

// okey = ref_scalar("__join_r__", int(rk)) — right-outer unmatched rows
PyObject* join_okey_r(PyObject* rk) {
    Hasher h;
    static const char kJ[] = "__join_r__";
    h.tag(0x04);
    h.u64le(sizeof(kJ) - 1);
    h.bytes(kJ, sizeof(kJ) - 1);
    if (!feed_pylong_plain(h, rk)) return nullptr;
    PyObject* num = digest_to_long(h);
    if (num == nullptr) return nullptr;
    return pointer_from_long(num);
}

struct JoinCtx {
    int64_t kind;  // 0 inner, 1 left, 2 right, 3 outer
    int left_id_only;
    Py_ssize_t lncols, rncols;
    PyObject* lnone;  // (None,)*lncols
    PyObject* rnone;
    PyObject* engine_error;
};

// output row = lv + rv + (lk, rk), built in one allocation
PyObject* join_row(JoinCtx& C, PyObject* lv, PyObject* rv, PyObject* lk,
                   PyObject* rk) {
    if (lv == nullptr) lv = C.lnone;
    if (rv == nullptr) rv = C.rnone;
    if (!PyTuple_Check(lv) || !PyTuple_Check(rv)) {
        // exotic row type: generic concat path
        PyObject* lr = PySequence_Concat(lv, rv);
        if (lr == nullptr) return nullptr;
        PyObject* tail = PyTuple_Pack(2, lk, rk);
        if (tail == nullptr) {
            Py_DECREF(lr);
            return nullptr;
        }
        PyObject* row = PySequence_Concat(lr, tail);
        Py_DECREF(lr);
        Py_DECREF(tail);
        return row;
    }
    Py_ssize_t ln = PyTuple_GET_SIZE(lv), rn = PyTuple_GET_SIZE(rv);
    PyObject* row = PyTuple_New(ln + rn + 2);
    if (row == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < ln; i++) {
        PyObject* x = PyTuple_GET_ITEM(lv, i);
        Py_INCREF(x);
        PyTuple_SET_ITEM(row, i, x);
    }
    for (Py_ssize_t i = 0; i < rn; i++) {
        PyObject* x = PyTuple_GET_ITEM(rv, i);
        Py_INCREF(x);
        PyTuple_SET_ITEM(row, ln + i, x);
    }
    Py_INCREF(lk);
    PyTuple_SET_ITEM(row, ln + rn, lk);
    Py_INCREF(rk);
    PyTuple_SET_ITEM(row, ln + rn + 1, rk);
    return row;
}

// Build the full output block {okey: lv+rv+(lk,rk)} for one join key.
// Returns a NEW dict, or nullptr with exception set.
// SQL outer semantics: a null-jk row never matches but IS retained
// unmatched on its preserved side.  Such rows are stateless
// passthroughs (mirrors JoinNode._split_null_keys on the Python
// fallback); rows are built by join_row/join_okey, the same
// constructors the blocks use.
int join_emit_null_passthroughs(JoinCtx& C, PyObject* seq, PyObject* jks,
                                bool left_side, PyObject* out,
                                PyObject* update_cls) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        if (PyList_GET_ITEM(jks, i) != Py_None) continue;
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        PyObject* diff = PyTuple_GET_ITEM(u, 2);
        PyObject* okey;
        PyObject* row;
        if (left_side) {
            if (C.left_id_only) {
                Py_INCREF(key);
                okey = key;
            } else {
                okey = join_okey(key, nullptr);
                if (okey == nullptr) return -1;
            }
            row = join_row(C, values, nullptr, key, Py_None);
        } else {
            okey = join_okey_r(key);
            if (okey == nullptr) return -1;
            row = join_row(C, nullptr, values, Py_None, key);
        }
        if (row == nullptr) {
            Py_DECREF(okey);
            return -1;
        }
        PyObject* nu = make_update_obj(update_cls, okey, row, diff);
        Py_DECREF(okey);
        Py_DECREF(row);
        if (nu == nullptr || PyList_Append(out, nu) < 0) {
            Py_XDECREF(nu);
            return -1;
        }
        Py_DECREF(nu);
    }
    return 0;
}

PyObject* join_block(JoinCtx& C, PyObject* lrows, PyObject* rrows) {
    PyObject* out = PyDict_New();
    if (out == nullptr) return nullptr;
    Py_ssize_t nl = lrows ? PyDict_GET_SIZE(lrows) : 0;
    Py_ssize_t nr = rrows ? PyDict_GET_SIZE(rrows) : 0;
    if (nl > 0 && nr > 0) {
        if (C.left_id_only && nr > 1) {
            PyErr_Format(C.engine_error,
                         "join with id=left.id: left row has %zd right matches",
                         nr);
            Py_DECREF(out);
            return nullptr;
        }
        Py_ssize_t lpos = 0;
        PyObject *lk, *lv;
        while (PyDict_Next(lrows, &lpos, &lk, &lv)) {
            Py_ssize_t rpos = 0;
            PyObject *rk, *rv;
            while (PyDict_Next(rrows, &rpos, &rk, &rv)) {
                PyObject* okey;
                if (C.left_id_only) {
                    Py_INCREF(lk);
                    okey = lk;
                } else {
                    okey = join_okey(lk, rk);
                    if (okey == nullptr) {
                        if (!PyErr_Occurred())
                            PyErr_SetString(g_unsupported,
                                            "join key hash fallback");
                        Py_DECREF(out);
                        return nullptr;
                    }
                }
                PyObject* row = join_row(C, lv, rv, lk, rk);
                if (row == nullptr || PyDict_SetItem(out, okey, row) < 0) {
                    Py_XDECREF(row);
                    Py_DECREF(okey);
                    Py_DECREF(out);
                    return nullptr;
                }
                Py_DECREF(row);
                Py_DECREF(okey);
            }
        }
    } else if (nl > 0 && (C.kind == 1 || C.kind == 3)) {
        Py_ssize_t lpos = 0;
        PyObject *lk, *lv;
        while (PyDict_Next(lrows, &lpos, &lk, &lv)) {
            PyObject* okey;
            if (C.left_id_only) {
                Py_INCREF(lk);
                okey = lk;
            } else {
                okey = join_okey(lk, nullptr);
                if (okey == nullptr) {
                    Py_DECREF(out);
                    return nullptr;
                }
            }
            PyObject* row = join_row(C, lv, nullptr, lk, Py_None);
            if (row == nullptr || PyDict_SetItem(out, okey, row) < 0) {
                Py_XDECREF(row);
                Py_DECREF(okey);
                Py_DECREF(out);
                return nullptr;
            }
            Py_DECREF(row);
            Py_DECREF(okey);
        }
    } else if (nr > 0 && (C.kind == 2 || C.kind == 3)) {
        Py_ssize_t rpos = 0;
        PyObject *rk, *rv;
        while (PyDict_Next(rrows, &rpos, &rk, &rv)) {
            PyObject* okey = join_okey_r(rk);
            if (okey == nullptr) {
                Py_DECREF(out);
                return nullptr;
            }
            PyObject* row = join_row(C, nullptr, rv, Py_None, rk);
            if (row == nullptr || PyDict_SetItem(out, okey, row) < 0) {
                Py_XDECREF(row);
                Py_DECREF(okey);
                Py_DECREF(out);
                return nullptr;
            }
            Py_DECREF(row);
            Py_DECREF(okey);
        }
    }
    return out;
}

// Evaluate one side's join keys: list (same length as batch) of jk tuple
// or None (null join key).  Pre-mutation: any obstacle -> Unsupported.
PyObject* join_side_jks(VmProgram* prog, PyObject* seq, PyObject* error_obj,
                        std::vector<PyObject*>& stack) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(n);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            Py_DECREF(out);
            return nullptr;
        }
        PyObject* kv = nullptr;
        PyObject* jk = vm_eval(prog, PyTuple_GET_ITEM(u, 0),
                               PyTuple_GET_ITEM(u, 1), error_obj, &kv, stack);
        Py_XDECREF(kv);
        if (jk == nullptr) {
            // VM row error: punt the whole batch to the Python path
            PyErr_Clear();
            PyErr_SetString(g_unsupported, "join key eval fallback");
            Py_DECREF(out);
            return nullptr;
        }
        // null join keys never match
        bool null_jk = false;
        if (PyTuple_Check(jk)) {
            for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(jk); j++)
                if (PyTuple_GET_ITEM(jk, j) == Py_None) null_jk = true;
        } else {
            null_jk = jk == Py_None;
        }
        if (null_jk) {
            Py_DECREF(jk);
            Py_INCREF(Py_None);
            PyList_SET_ITEM(out, i, Py_None);
            continue;
        }
        if (PyObject_Hash(jk) == -1) {
            // unhashable cells (python path would use hashable_row):
            // pre-mutation, safe to fall back
            PyErr_Clear();
            PyErr_SetString(g_unsupported, "unhashable join key");
            Py_DECREF(jk);
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, jk);
    }
    return out;
}

int join_apply_side(PyObject* side, PyObject* seq, PyObject* jks) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* jk = PyList_GET_ITEM(jks, i);
        if (jk == Py_None) continue;
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        PyObject* diff = PyTuple_GET_ITEM(u, 2);
        PyObject* rows = PyDict_GetItemWithError(side, jk);  // borrowed
        if (rows == nullptr) {
            if (PyErr_Occurred()) return -1;
            rows = PyDict_New();
            if (rows == nullptr) return -1;
            if (PyDict_SetItem(side, jk, rows) < 0) {
                Py_DECREF(rows);
                return -1;
            }
            Py_DECREF(rows);  // dict holds it; borrow below is safe
            rows = PyDict_GetItemWithError(side, jk);
            if (rows == nullptr) return -1;
        }
        long d = PyLong_AsLong(diff);
        if (d == -1 && PyErr_Occurred()) return -1;
        if (d > 0) {
            if (PyDict_SetItem(rows, key, values) < 0) return -1;
        } else {
            if (PyDict_DelItem(rows, key) < 0) {
                if (!PyErr_ExceptionMatches(PyExc_KeyError)) return -1;
                PyErr_Clear();
            }
        }
    }
    return 0;
}

PyObject* py_join_process(PyObject*, PyObject* args) {
    // (lbatch, rbatch, lprog, rprog, lstate, rstate, kind, left_id_only,
    //  lncols, rncols, update_cls, error_obj, engine_error_cls)
    PyObject *lbatch, *rbatch, *lcap, *rcap, *lstate, *rstate;
    PyObject *update_cls, *error_obj, *engine_error;
    long long kind, left_id_only, lncols, rncols;
    if (!PyArg_ParseTuple(args, "OOOOO!O!LLLLOOO", &lbatch, &rbatch, &lcap,
                          &rcap, &PyDict_Type, &lstate, &PyDict_Type, &rstate,
                          &kind, &left_id_only, &lncols, &rncols, &update_cls,
                          &error_obj, &engine_error))
        return nullptr;
    if (g_pointer_type == nullptr) {
        PyErr_SetString(g_unsupported, "Pointer type not registered");
        return nullptr;
    }
    VmProgram* LP = vm_from_capsule(lcap);
    if (LP == nullptr) return nullptr;
    VmProgram* RP = vm_from_capsule(rcap);
    if (RP == nullptr) return nullptr;

    JoinCtx C;
    C.kind = kind;
    C.left_id_only = (int)left_id_only;
    C.lncols = (Py_ssize_t)lncols;
    C.rncols = (Py_ssize_t)rncols;
    C.engine_error = engine_error;
    C.lnone = PyTuple_New(C.lncols);
    C.rnone = PyTuple_New(C.rncols);
    if (C.lnone == nullptr || C.rnone == nullptr) {
        Py_XDECREF(C.lnone);
        Py_XDECREF(C.rnone);
        return nullptr;
    }
    for (Py_ssize_t i = 0; i < C.lncols; i++) {
        Py_INCREF(Py_None);
        PyTuple_SET_ITEM(C.lnone, i, Py_None);
    }
    for (Py_ssize_t i = 0; i < C.rncols; i++) {
        Py_INCREF(Py_None);
        PyTuple_SET_ITEM(C.rnone, i, Py_None);
    }

    PyObject *lseq = nullptr, *rseq = nullptr, *ljks = nullptr,
             *rjks = nullptr, *dirty = nullptr, *dirty_list = nullptr,
             *old_blocks = nullptr, *out = nullptr;
    bool mutated = false;
    std::vector<PyObject*> stack(
        std::max(LP->max_stack, RP->max_stack) + 2);

    lseq = PySequence_Fast(lbatch, "join: left batch");
    if (lseq == nullptr) goto fail;
    rseq = PySequence_Fast(rbatch, "join: right batch");
    if (rseq == nullptr) goto fail;
    ljks = join_side_jks(LP, lseq, error_obj, stack);
    if (ljks == nullptr) goto fail;
    rjks = join_side_jks(RP, rseq, error_obj, stack);
    if (rjks == nullptr) goto fail;

    // dirty key set (insertion-ordered via companion list)
    dirty = PySet_New(nullptr);
    dirty_list = PyList_New(0);
    if (dirty == nullptr || dirty_list == nullptr) goto fail;
    for (PyObject* jks : {ljks, rjks}) {
        Py_ssize_t n = PyList_GET_SIZE(jks);
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject* jk = PyList_GET_ITEM(jks, i);
            if (jk == Py_None) continue;
            int has = PySet_Contains(dirty, jk);
            if (has < 0) goto fail;
            if (!has) {
                if (PySet_Add(dirty, jk) < 0) goto fail;
                if (PyList_Append(dirty_list, jk) < 0) goto fail;
            }
        }
    }

    // old blocks BEFORE mutation
    old_blocks = PyList_New(0);
    if (old_blocks == nullptr) goto fail;
    {
        Py_ssize_t nd = PyList_GET_SIZE(dirty_list);
        for (Py_ssize_t i = 0; i < nd; i++) {
            PyObject* jk = PyList_GET_ITEM(dirty_list, i);
            PyObject* lrows = PyDict_GetItemWithError(lstate, jk);
            if (lrows == nullptr && PyErr_Occurred()) goto fail;
            PyObject* rrows = PyDict_GetItemWithError(rstate, jk);
            if (rrows == nullptr && PyErr_Occurred()) goto fail;
            if ((lrows == nullptr || PyDict_GET_SIZE(lrows) == 0) &&
                (rrows == nullptr || PyDict_GET_SIZE(rrows) == 0)) {
                // brand-new join key (bulk-load common case): empty old
                // block — Py_None placeholder skips a dict allocation
                if (PyList_Append(old_blocks, Py_None) < 0) goto fail;
                continue;
            }
            PyObject* blk = join_block(C, lrows, rrows);
            if (blk == nullptr) goto fail;
            int rc = PyList_Append(old_blocks, blk);
            Py_DECREF(blk);
            if (rc < 0) goto fail;
        }
    }

    // mutate arrangements — from here on, Unsupported must NOT escape
    // (the Python fallback would re-apply the batch to mutated state)
    mutated = true;
    if (join_apply_side(lstate, lseq, ljks) < 0) goto fail;
    if (join_apply_side(rstate, rseq, rjks) < 0) goto fail;

    // new blocks + diff
    out = PyList_New(0);
    if (out == nullptr) goto fail;
    if (C.kind == 1 || C.kind == 3) {  // left / outer preserve left nulls
        if (join_emit_null_passthroughs(C, lseq, ljks, true, out,
                                        update_cls) < 0)
            goto fail;
    }
    if (C.kind == 2 || C.kind == 3) {  // right / outer preserve right nulls
        if (join_emit_null_passthroughs(C, rseq, rjks, false, out,
                                        update_cls) < 0)
            goto fail;
    }
    {
        PyObject* one = PyLong_FromLong(1);
        PyObject* neg = PyLong_FromLong(-1);
        if (one == nullptr || neg == nullptr) {
            Py_XDECREF(one);
            Py_XDECREF(neg);
            goto fail;
        }
        Py_ssize_t nd = PyList_GET_SIZE(dirty_list);
        bool ok = true;
        for (Py_ssize_t i = 0; i < nd && ok; i++) {
            PyObject* jk = PyList_GET_ITEM(dirty_list, i);
            PyObject* lrows = PyDict_GetItemWithError(lstate, jk);
            PyObject* rrows = PyDict_GetItemWithError(rstate, jk);
            PyObject* old_blk = PyList_GET_ITEM(old_blocks, i);
            if (old_blk == Py_None) {
                // brand-new join key: every block row is an addition and
                // okeys are unique per (lk, rk) pair — emit straight from
                // the arrangements, skipping the block dict entirely
                PyObject* blk = join_block(C, lrows, rrows);
                if (blk == nullptr) {
                    ok = false;
                    break;
                }
                Py_ssize_t pos2 = 0;
                PyObject *okey2, *vals2;
                while (ok && PyDict_Next(blk, &pos2, &okey2, &vals2)) {
                    PyObject* nu =
                        make_update_obj(update_cls, okey2, vals2, one);
                    if (nu == nullptr || PyList_Append(out, nu) < 0) {
                        Py_XDECREF(nu);
                        ok = false;
                        break;
                    }
                    Py_DECREF(nu);
                }
                Py_DECREF(blk);
                if (!ok) break;
                // same empty-arrangement cleanup as the diff path (an
                // add+retract within one epoch leaves empty dicts)
                bool lempty2 =
                    lrows == nullptr || PyDict_GET_SIZE(lrows) == 0;
                bool rempty2 =
                    rrows == nullptr || PyDict_GET_SIZE(rrows) == 0;
                if (lempty2 && rempty2) {
                    if (lrows != nullptr && PyDict_DelItem(lstate, jk) < 0)
                        PyErr_Clear();
                    if (rrows != nullptr && PyDict_DelItem(rstate, jk) < 0)
                        PyErr_Clear();
                }
                continue;
            }
            PyObject* new_blk = join_block(C, lrows, rrows);
            if (new_blk == nullptr) {
                ok = false;
                break;
            }
            // retractions: old rows missing/changed in new
            Py_ssize_t pos = 0;
            PyObject *okey, *vals;
            while (ok && old_blk != Py_None &&
                   PyDict_Next(old_blk, &pos, &okey, &vals)) {
                PyObject* nv = PyDict_GetItemWithError(new_blk, okey);
                if (nv == nullptr && PyErr_Occurred()) {
                    ok = false;
                    break;
                }
                int same = nv == nullptr
                               ? 0
                               : PyObject_RichCompareBool(nv, vals, Py_EQ);
                if (same < 0) {
                    ok = false;
                    break;
                }
                if (!same) {
                    PyObject* nu = make_update_obj(update_cls, okey, vals, neg);
                    if (nu == nullptr || PyList_Append(out, nu) < 0) {
                        Py_XDECREF(nu);
                        ok = false;
                        break;
                    }
                    Py_DECREF(nu);
                }
            }
            // additions: new rows missing/changed in old
            pos = 0;
            while (ok && PyDict_Next(new_blk, &pos, &okey, &vals)) {
                PyObject* ov =
                    old_blk == Py_None
                        ? nullptr
                        : PyDict_GetItemWithError(old_blk, okey);
                if (ov == nullptr && PyErr_Occurred()) {
                    ok = false;
                    break;
                }
                int same = ov == nullptr
                               ? 0
                               : PyObject_RichCompareBool(ov, vals, Py_EQ);
                if (same < 0) {
                    ok = false;
                    break;
                }
                if (!same) {
                    PyObject* nu = make_update_obj(update_cls, okey, vals, one);
                    if (nu == nullptr || PyList_Append(out, nu) < 0) {
                        Py_XDECREF(nu);
                        ok = false;
                        break;
                    }
                    Py_DECREF(nu);
                }
            }
            Py_DECREF(new_blk);
            if (!ok) break;
            // drop fully-empty arrangements
            bool lempty = lrows == nullptr || PyDict_GET_SIZE(lrows) == 0;
            bool rempty = rrows == nullptr || PyDict_GET_SIZE(rrows) == 0;
            if (lempty && rempty) {
                if (lrows != nullptr && PyDict_DelItem(lstate, jk) < 0)
                    PyErr_Clear();
                if (rrows != nullptr && PyDict_DelItem(rstate, jk) < 0)
                    PyErr_Clear();
            }
        }
        Py_DECREF(one);
        Py_DECREF(neg);
        if (!ok) goto fail;
    }

    Py_DECREF(lseq);
    Py_DECREF(rseq);
    Py_DECREF(ljks);
    Py_DECREF(rjks);
    Py_DECREF(dirty);
    Py_DECREF(dirty_list);
    Py_DECREF(old_blocks);
    Py_DECREF(C.lnone);
    Py_DECREF(C.rnone);
    return out;
fail:
    if (mutated && PyErr_ExceptionMatches(g_unsupported)) {
        // never let the caller rerun an already-applied batch
        PyErr_SetString(PyExc_RuntimeError,
                        "native join pass failed after state mutation");
    }
    Py_XDECREF(lseq);
    Py_XDECREF(rseq);
    Py_XDECREF(ljks);
    Py_XDECREF(rjks);
    Py_XDECREF(dirty);
    Py_XDECREF(dirty_list);
    Py_XDECREF(old_blocks);
    Py_XDECREF(C.lnone);
    Py_XDECREF(C.rnone);
    Py_XDECREF(out);
    return nullptr;
}

PyObject* py_vm_filter_batch(PyObject*, PyObject* args) {
    // (batch, prog_capsule, error_obj) -> surviving updates unchanged.
    // Drop semantics mirror FilterNode/filter_batch: raising rows, None,
    // and ERROR all drop; anything else keeps by truthiness.
    PyObject *batch, *cap, *error_obj;
    if (!PyArg_ParseTuple(args, "OOO", &batch, &cap, &error_obj))
        return nullptr;
    VmProgram* P = vm_from_capsule(cap);
    if (P == nullptr) return nullptr;
    PyObject* seq =
        PySequence_Fast(batch, "vm_filter_batch expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    PyObject* out = PyList_New(0);
    if (out == nullptr) {
        Py_DECREF(seq);
        return nullptr;
    }
    std::vector<PyObject*> stack(P->max_stack);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            goto fail;
        }
        {
            PyObject* kv = nullptr;
            PyObject* r = vm_eval(P, PyTuple_GET_ITEM(u, 0),
                                  PyTuple_GET_ITEM(u, 1), error_obj, &kv,
                                  stack);
            Py_XDECREF(kv);
            if (r == nullptr) {
                if (!PyErr_ExceptionMatches(PyExc_Exception)) goto fail;
                PyErr_Clear();
                continue;  // raising predicate: drop the row
            }
            if (r == Py_None || r == error_obj) {
                Py_DECREF(r);
                continue;
            }
            int truthy = PyObject_IsTrue(r);
            Py_DECREF(r);
            if (truthy < 0) goto fail;
            if (truthy && PyList_Append(out, u) < 0) goto fail;
        }
    }
    Py_DECREF(seq);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    return nullptr;
}

// ===========================================================================
// HNSW graph ANN index
//
// Host-side hierarchical navigable small-world index, the role of the
// reference's usearch integration
// (src/external_integration/usearch_integration.rs:1-163): greedy
// multi-layer descent + ef-bounded best-first search on layer 0, Malkov
// neighbor-selection heuristic, tombstone removals with slot reuse.
// The pointer-chasing walk is hostile to XLA, so unlike the brute-force
// and IVF indexes this one lives entirely on the host — in C++, since a
// per-hop Python interpreter step would dominate the traversal.
// Vectors are float32, contiguous; cos uses pre-normalized vectors with
// distance = -dot (the Python wrapper normalizes).

struct HnswIndex {
    int dim, M, M0, efc, metric;  // metric: 0 ip (-dot; cos = normalized ip), 1 l2sq
    //: add/search/remove release the GIL around the graph work; this
    //: mutex is what actually serializes them (search mutates the
    //: visited stamps too, so even concurrent reads need it)
    std::mutex mu;
    double inv_log_m;
    std::vector<float> vecs;                             // slot*dim
    std::vector<int> levels;                             // per slot
    std::vector<std::vector<std::vector<uint32_t>>> links;  // slot -> level -> ids
    std::vector<uint8_t> alive;
    std::vector<uint32_t> freelist;
    std::vector<uint32_t> visited_stamp;
    uint32_t stamp = 0;
    int64_t entry = -1;
    int max_level = -1;
    size_t n_alive = 0;
    uint64_t rng = 0x9e3779b97f4a7c15ULL;

    float dist(const float* a, const float* b) const {
        float acc = 0.f;
        if (metric == 1) {
            for (int i = 0; i < dim; i++) {
                float d = a[i] - b[i];
                acc += d * d;
            }
            return acc;
        }
        for (int i = 0; i < dim; i++) acc += a[i] * b[i];
        return -acc;
    }
    const float* vec(uint32_t s) const { return vecs.data() + (size_t)s * dim; }
    uint64_t next_rand() {
        rng ^= rng << 13;
        rng ^= rng >> 7;
        rng ^= rng << 17;
        return rng;
    }
    int random_level() {
        double u = ((next_rand() >> 11) + 1) * (1.0 / 9007199254740992.0);
        int l = (int)(-std::log(u) * inv_log_m);
        return l < 32 ? l : 32;
    }
    bool visit(uint32_t s) {  // true if first visit this query
        if (visited_stamp.size() < levels.size())
            visited_stamp.resize(levels.size(), 0);
        if (visited_stamp[s] == stamp) return false;
        visited_stamp[s] = stamp;
        return true;
    }
};

void hnsw_capsule_free(PyObject* cap) {
    delete static_cast<HnswIndex*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.hnsw"));
}

inline HnswIndex* hnsw_from_capsule(PyObject* cap) {
    return static_cast<HnswIndex*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.hnsw"));
}

using DistSlot = std::pair<float, uint32_t>;  // (distance, slot)

// best-first search on one layer; returns up to ef closest (sorted asc)
void hnsw_search_layer(HnswIndex& H, const float* q, uint32_t start, int ef,
                       int level, std::vector<DistSlot>& out) {
    H.stamp++;
    std::priority_queue<DistSlot, std::vector<DistSlot>,
                        std::greater<DistSlot>>
        cand;  // min-heap by distance
    std::priority_queue<DistSlot> best;  // max-heap by distance
    float d0 = H.dist(q, H.vec(start));
    H.visit(start);
    cand.push({d0, start});
    best.push({d0, start});
    while (!cand.empty()) {
        DistSlot c = cand.top();
        if (c.first > best.top().first && (int)best.size() >= ef) break;
        cand.pop();
        if ((int)H.links[c.second].size() <= level) continue;
        for (uint32_t nb : H.links[c.second][level]) {
            if (!H.visit(nb)) continue;
            float d = H.dist(q, H.vec(nb));
            if ((int)best.size() < ef || d < best.top().first) {
                cand.push({d, nb});
                best.push({d, nb});
                if ((int)best.size() > ef) best.pop();
            }
        }
    }
    out.clear();
    out.resize(best.size());
    for (size_t i = best.size(); i-- > 0;) {
        out[i] = best.top();
        best.pop();
    }
}

// Malkov heuristic: keep a candidate only if it is closer to q than to
// every already-selected neighbor (diversity), up to M
void hnsw_select_neighbors(HnswIndex& H, const float* q,
                           const std::vector<DistSlot>& cand, int M,
                           std::vector<uint32_t>& out) {
    out.clear();
    for (const auto& c : cand) {
        if ((int)out.size() >= M) break;
        bool good = true;
        for (uint32_t s : out) {
            if (H.dist(H.vec(c.second), H.vec(s)) < c.first) {
                good = false;
                break;
            }
        }
        if (good) out.push_back(c.second);
    }
    // backfill with closest skipped candidates if diversity starved us
    if ((int)out.size() < M) {
        for (const auto& c : cand) {
            if ((int)out.size() >= M) break;
            if (std::find(out.begin(), out.end(), c.second) == out.end())
                out.push_back(c.second);
        }
    }
}

void hnsw_prune(HnswIndex& H, uint32_t s, int level, int cap) {
    auto& lst = H.links[s][level];
    if ((int)lst.size() <= cap) return;
    std::vector<DistSlot> cand;
    cand.reserve(lst.size());
    for (uint32_t nb : lst) cand.push_back({H.dist(H.vec(s), H.vec(nb)), nb});
    std::sort(cand.begin(), cand.end());
    std::vector<uint32_t> kept;
    hnsw_select_neighbors(H, H.vec(s), cand, cap, kept);
    lst = std::move(kept);
}

uint32_t hnsw_insert(HnswIndex& H, const float* v) {
    uint32_t slot;
    bool reused = false;
    if (!H.freelist.empty()) {
        // hnswlib-style update-in-place: the tombstone's old links are
        // KEPT (they may be the only bridges through its neighborhood —
        // clearing them measurably disconnects the graph under churn)
        // and the fresh links from the normal insert procedure are
        // merged in below, with pruning gradually retiring the
        // wrong-distance old edges.
        slot = H.freelist.back();
        H.freelist.pop_back();
        reused = !H.links[slot].empty();
        std::copy(v, v + H.dim, H.vecs.begin() + (size_t)slot * H.dim);
        H.alive[slot] = 1;
        if (H.entry == (int64_t)slot) {
            // the reused slot WAS the (tombstoned) entry: the insert
            // below must not greedy-start from the node being inserted.
            // Re-seed the entry with the highest-level other node.
            int64_t other = -1;
            int best = -1;
            for (size_t i = 0; i < H.levels.size(); i++) {
                if (i == (size_t)slot) continue;
                int lv = (int)H.links[i].size() - 1;
                if (lv > best) {
                    best = lv;
                    other = (int64_t)i;
                }
            }
            H.entry = other;
            H.max_level = best < 0 ? -1 : best;
        }
    } else {
        slot = (uint32_t)H.levels.size();
        H.vecs.insert(H.vecs.end(), v, v + H.dim);
        H.levels.push_back(0);
        H.links.emplace_back();
        H.alive.push_back(1);
    }
    int level = H.random_level();
    if (reused)  // keep the inherited high-level edges reachable
        level = std::max(level, (int)H.links[slot].size() - 1);
    H.levels[slot] = level;
    H.links[slot].resize(level + 1);
    H.n_alive++;
    if (H.entry < 0) {
        H.entry = slot;
        H.max_level = level;
        return slot;
    }
    uint32_t cur = (uint32_t)H.entry;
    float dcur = H.dist(v, H.vec(cur));
    for (int l = H.max_level; l > level; l--) {
        bool moved = true;
        while (moved) {
            moved = false;
            if ((int)H.links[cur].size() <= l) break;
            for (uint32_t nb : H.links[cur][l]) {
                float d = H.dist(v, H.vec(nb));
                if (d < dcur) {
                    dcur = d;
                    cur = nb;
                    moved = true;
                }
            }
        }
    }
    std::vector<DistSlot> cand;
    std::vector<uint32_t> sel;
    for (int l = std::min(level, H.max_level); l >= 0; l--) {
        hnsw_search_layer(H, v, cur, H.efc, l, cand);
        if (reused) {
            // the node under (re)insertion is itself reachable through
            // its inherited in/out edges — it must not self-select
            cand.erase(std::remove_if(cand.begin(), cand.end(),
                                      [slot](const DistSlot& c) {
                                          return c.second == slot;
                                      }),
                       cand.end());
            if (cand.empty()) continue;
        }
        int cap = l == 0 ? H.M0 : H.M;
        hnsw_select_neighbors(H, v, cand, cap, sel);
        auto& own = H.links[slot][l];
        for (uint32_t nb : sel)
            if (std::find(own.begin(), own.end(), nb) == own.end())
                own.push_back(nb);
        hnsw_prune(H, slot, l, cap);
        for (uint32_t nb : sel) {
            if ((int)H.links[nb].size() <= l) H.links[nb].resize(l + 1);
            auto& lnb = H.links[nb][l];
            if (std::find(lnb.begin(), lnb.end(), slot) == lnb.end())
                lnb.push_back(slot);
            hnsw_prune(H, nb, l, l == 0 ? H.M0 : H.M);
        }
        if (!cand.empty()) cur = cand[0].second;
    }
    if (level > H.max_level) {
        H.max_level = level;
        H.entry = slot;
    }
    return slot;
}

PyObject* py_hnsw_new(PyObject*, PyObject* args) {
    // (dim, M, ef_construction, metric:int 0 ip | 1 l2sq) -> capsule
    long long dim, M, efc, metric;
    if (!PyArg_ParseTuple(args, "LLLL", &dim, &M, &efc, &metric))
        return nullptr;
    if (dim <= 0 || M < 2 || efc < M || (metric != 0 && metric != 1)) {
        PyErr_SetString(PyExc_ValueError, "bad HNSW parameters");
        return nullptr;
    }
    auto* H = new HnswIndex();
    H->dim = (int)dim;
    H->M = (int)M;
    H->M0 = (int)(2 * M);
    H->efc = (int)efc;
    H->metric = (int)metric;
    H->inv_log_m = 1.0 / std::log((double)M);
    return PyCapsule_New(H, "pathway_tpu.hnsw", hnsw_capsule_free);
}

// parse a C-contiguous float32 (n, dim) buffer
int hnsw_get_matrix(PyObject* obj, int dim, Py_buffer* view,
                    Py_ssize_t* n_out) {
    if (PyObject_GetBuffer(obj, view, PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
        return -1;
    bool f32 = view->format == nullptr || strcmp(view->format, "f") == 0;
    if (!f32 || view->itemsize != 4 || view->len % (dim * 4) != 0) {
        PyBuffer_Release(view);
        PyErr_SetString(PyExc_TypeError,
                        "expected C-contiguous float32 (n, dim) buffer");
        return -1;
    }
    *n_out = view->len / (dim * 4);
    return 0;
}

PyObject* py_hnsw_add(PyObject*, PyObject* args) {
    // (capsule, float32 (n, dim) buffer) -> list of assigned slots
    PyObject *cap, *buf;
    if (!PyArg_ParseTuple(args, "OO", &cap, &buf)) return nullptr;
    HnswIndex* H = hnsw_from_capsule(cap);
    if (H == nullptr) return nullptr;
    Py_buffer view;
    Py_ssize_t n;
    if (hnsw_get_matrix(buf, H->dim, &view, &n) < 0) return nullptr;
    std::vector<uint32_t> slots((size_t)n);
    const float* data = static_cast<const float*>(view.buf);
    Py_BEGIN_ALLOW_THREADS;
    {
        std::lock_guard<std::mutex> lock(H->mu);
        for (Py_ssize_t i = 0; i < n; i++)
            slots[(size_t)i] = hnsw_insert(*H, data + (size_t)i * H->dim);
    }
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&view);
    PyObject* out = PyList_New(n);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* v = PyLong_FromUnsignedLong(slots[(size_t)i]);
        if (v == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, i, v);
    }
    return out;
}

PyObject* py_hnsw_remove(PyObject*, PyObject* args) {
    // (capsule, iterable of slots) — tombstone + slot reuse
    PyObject *cap, *slots_obj;
    if (!PyArg_ParseTuple(args, "OO", &cap, &slots_obj)) return nullptr;
    HnswIndex* H = hnsw_from_capsule(cap);
    if (H == nullptr) return nullptr;
    PyObject* seq = PySequence_Fast(slots_obj, "hnsw_remove expects slots");
    if (seq == nullptr) return nullptr;
    {
        // serialize against GIL-released add/search; safe to hold with
        // the GIL because mutex holders never ACQUIRE the GIL themselves
        std::lock_guard<std::mutex> lock(H->mu);
        for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
            long long s = PyLong_AsLongLong(PySequence_Fast_GET_ITEM(seq, i));
            if (s == -1 && PyErr_Occurred()) {
                Py_DECREF(seq);
                return nullptr;
            }
            if (s < 0 || (size_t)s >= H->alive.size() || !H->alive[(size_t)s])
                continue;
            H->alive[(size_t)s] = 0;
            H->freelist.push_back((uint32_t)s);
            H->n_alive--;
        }
        if (H->n_alive == 0) {  // empty graph: full reset
            H->vecs.clear();
            H->levels.clear();
            H->links.clear();
            H->alive.clear();
            H->freelist.clear();
            H->entry = -1;
            H->max_level = -1;
        }
    }
    Py_DECREF(seq);
    Py_RETURN_NONE;
}

PyObject* py_hnsw_search(PyObject*, PyObject* args) {
    // (capsule, float32 (nq, dim) buffer, k, ef) -> list of
    // ([slots...], [dists...]) per query; tombstones excluded
    PyObject *cap, *buf;
    long long k, ef;
    if (!PyArg_ParseTuple(args, "OOLL", &cap, &buf, &k, &ef)) return nullptr;
    HnswIndex* H = hnsw_from_capsule(cap);
    if (H == nullptr) return nullptr;
    Py_buffer view;
    Py_ssize_t nq;
    if (hnsw_get_matrix(buf, H->dim, &view, &nq) < 0) return nullptr;
    const float* data = static_cast<const float*>(view.buf);
    int eff_ef = (int)std::max(ef, k);
    std::vector<std::vector<DistSlot>> results((size_t)nq);
    Py_BEGIN_ALLOW_THREADS;
    // inner scope: the mutex MUST release before Py_END reacquires the
    // GIL, or a GIL-holding caller blocked on the mutex deadlocks us
    {
    std::lock_guard<std::mutex> lock(H->mu);
    for (Py_ssize_t qi = 0; qi < nq; qi++) {
        if (H->entry < 0) continue;
        const float* q = data + (size_t)qi * H->dim;
        uint32_t cur = (uint32_t)H->entry;
        float dcur = H->dist(q, H->vec(cur));
        for (int l = H->max_level; l > 0; l--) {
            bool moved = true;
            while (moved) {
                moved = false;
                if ((int)H->links[cur].size() <= l) break;
                for (uint32_t nb : H->links[cur][l]) {
                    float d = H->dist(q, H->vec(nb));
                    if (d < dcur) {
                        dcur = d;
                        cur = nb;
                        moved = true;
                    }
                }
            }
        }
        std::vector<DistSlot> found;
        // tombstones participate in traversal but not in results; a
        // bounded slack absorbs light churn, and the Python wrapper
        // retries with a larger ef if survivors run short
        int fetch = eff_ef + std::min((int)(H->alive.size() - H->n_alive),
                                      eff_ef);
        if (fetch > (int)H->levels.size()) fetch = (int)H->levels.size();
        hnsw_search_layer(*H, q, cur, fetch, 0, found);
        auto& out = results[(size_t)qi];
        for (const auto& ds : found) {
            if (!H->alive[ds.second]) continue;
            out.push_back(ds);
            if ((int)out.size() >= k) break;
        }
    }
    }  // mutex released here, before the GIL reacquire below
    Py_END_ALLOW_THREADS;
    PyBuffer_Release(&view);
    PyObject* out = PyList_New(nq);
    if (out == nullptr) return nullptr;
    for (Py_ssize_t qi = 0; qi < nq; qi++) {
        const auto& r = results[(size_t)qi];
        PyObject* ids = PyList_New((Py_ssize_t)r.size());
        PyObject* ds = PyList_New((Py_ssize_t)r.size());
        PyObject* pair = (ids && ds) ? PyTuple_Pack(2, ids, ds) : nullptr;
        Py_XDECREF(ids);
        Py_XDECREF(ds);
        if (pair == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        for (size_t j = 0; j < r.size(); j++) {
            PyObject* i_ = PyLong_FromUnsignedLong(r[j].second);
            PyObject* d_ = PyFloat_FromDouble((double)r[j].first);
            if (i_ == nullptr || d_ == nullptr) {
                Py_XDECREF(i_);
                Py_XDECREF(d_);
                Py_DECREF(pair);
                Py_DECREF(out);
                return nullptr;
            }
            PyList_SET_ITEM(ids, (Py_ssize_t)j, i_);
            PyList_SET_ITEM(ds, (Py_ssize_t)j, d_);
        }
        PyList_SET_ITEM(out, qi, pair);
    }
    return out;
}

PyObject* py_hnsw_len(PyObject*, PyObject* cap) {
    HnswIndex* H = hnsw_from_capsule(cap);
    if (H == nullptr) return nullptr;
    return PyLong_FromSize_t(H->n_alive);
}

// ---------------------------------------------------------------------------
// Binary update framing for the inter-process exchange.
//
// The reference exchanges rows between worker processes as typed binary
// frames (timely's exchange channels serialize records with abomonation,
// external/timely-dataflow/communication/); the first TPU-build cluster
// shipped pickled (key, values, diff) lists instead, which made the
// 2-process wordcount *slower* than 1 process: pickling a Pointer
// int-subclass goes through copyreg per object, and the receive side
// rebuilt Update/Pointer objects in a per-row Python loop.  pack_updates
// / unpack_updates replace that with a tagged-scalar wire format written
// and parsed entirely in C++: 16 bytes of key, a zigzag-varint diff, and
// one tag byte per value (int64 / double / utf8 / bytes / bool / None /
// Pointer / nested tuple); anything outside the tag set (datetime,
// ndarray, Json, wrapped objects) is embedded as a single-object pickle,
// so the frame is always complete.

PyObject* g_update_type = nullptr;   // engine.stream.Update (NamedTuple)
PyObject* g_pickle_dumps = nullptr;  // pickle.dumps / loads for the
PyObject* g_pickle_loads = nullptr;  // out-of-tag-set value fallback

PyObject* py_set_update_type(PyObject*, PyObject* cls) {
    Py_XDECREF(g_update_type);
    Py_INCREF(cls);
    g_update_type = cls;
    if (g_pickle_dumps == nullptr) {
        PyObject* pickle = PyImport_ImportModule("pickle");
        if (pickle == nullptr) return nullptr;
        g_pickle_dumps = PyObject_GetAttrString(pickle, "dumps");
        g_pickle_loads = PyObject_GetAttrString(pickle, "loads");
        Py_DECREF(pickle);
        if (g_pickle_dumps == nullptr || g_pickle_loads == nullptr)
            return nullptr;
    }
    Py_RETURN_NONE;
}

enum : uint8_t {
    WT_NONE = 0,
    WT_TRUE = 1,
    WT_FALSE = 2,
    WT_I64 = 3,     // 8 bytes LE
    WT_F64 = 4,     // 8 bytes LE
    WT_STR = 5,     // u32 len + utf8
    WT_BYTES = 6,   // u32 len + raw
    WT_POINTER = 7, // u8 len + unsigned LE
    WT_TUPLE = 8,   // u8 arity + nested values
    WT_PICKLE = 9,  // u32 len + pickle bytes
    WT_STRREF = 10, // varint index into the frame's string table
};

// Per-frame string interning: group/join key columns repeat a small
// vocabulary across millions of rows, so the second and later
// occurrences of a string in a frame encode as a 1-2 byte table ref and
// decode as an INCREF of the already-built object (no UTF-8 decode, no
// allocation).  The table is IMPLICIT: both sides append every WT_STR
// they see (short ones, while there is room), so the wire carries no
// table section and a frame without refs is byte-identical to the
// pre-STRREF format.  The persistence codec (pack_kv) packs with
// interning disabled — snapshot bytes stay stable — but its decoder
// shares this logic and accepts refs regardless.
constexpr size_t kWfInternCap = 1 << 16;
constexpr size_t kWfInternMaxLen = 255;  // intern short strings only

struct WfIntern {
    std::unordered_map<std::string, uint32_t> map;
};

inline void wf_put_u32(std::string& b, uint32_t v) {
    b.append(reinterpret_cast<const char*>(&v), 4);
}
inline void wf_put_u64(std::string& b, uint64_t v) {
    b.append(reinterpret_cast<const char*>(&v), 8);
}
inline void wf_put_varint(std::string& b, long long sv) {
    // zigzag + LEB128 (diffs are almost always ±1: one byte)
    unsigned long long v =
        (static_cast<unsigned long long>(sv) << 1) ^
        static_cast<unsigned long long>(sv >> 63);
    while (v >= 0x80) {
        b.push_back(static_cast<char>(v | 0x80));
        v >>= 7;
    }
    b.push_back(static_cast<char>(v));
}

bool wf_pack_value(std::string& buf, PyObject* v,
                   WfIntern* intern);  // fwd (tuples recurse)

// u32 length fields cap any single value at 4 GiB; bigger ones abort the
// pack (the cluster layer falls back to whole-frame pickle) instead of
// writing a silently corrupt frame
constexpr size_t kWfMaxLen = 0xFFFFFFFFu;

bool wf_pack_pickled(std::string& buf, PyObject* v) {
    if (g_pickle_dumps == nullptr) {
        PyErr_SetString(PyExc_RuntimeError,
                        "pack_updates: pickle fallback unregistered");
        return false;
    }
    PyObject* data = PyObject_CallFunctionObjArgs(g_pickle_dumps, v, nullptr);
    if (data == nullptr) return false;
    char* p;
    Py_ssize_t n;
    if (PyBytes_AsStringAndSize(data, &p, &n) < 0) {
        Py_DECREF(data);
        return false;
    }
    if (static_cast<size_t>(n) > kWfMaxLen) {
        Py_DECREF(data);
        PyErr_SetString(PyExc_ValueError, "value too large for update frame");
        return false;
    }
    buf.push_back(static_cast<char>(WT_PICKLE));
    wf_put_u32(buf, static_cast<uint32_t>(n));
    buf.append(p, static_cast<size_t>(n));
    Py_DECREF(data);
    return true;
}

bool wf_pack_value(std::string& buf, PyObject* v, WfIntern* intern) {
    if (v == Py_None) {
        buf.push_back(static_cast<char>(WT_NONE));
    } else if (v == Py_True) {
        buf.push_back(static_cast<char>(WT_TRUE));
    } else if (v == Py_False) {
        buf.push_back(static_cast<char>(WT_FALSE));
    } else if (g_pointer_type != nullptr &&
               PyObject_TypeCheck(
                   v, reinterpret_cast<PyTypeObject*>(g_pointer_type))) {
        uint8_t kb[16];
        if (pt_long_as_bytes_unsigned(v, kb, sizeof kb) < 0) {
            PyErr_Clear();
            return wf_pack_pickled(buf, v);
        }
        buf.push_back(static_cast<char>(WT_POINTER));
        buf.push_back(static_cast<char>(sizeof kb));
        buf.append(reinterpret_cast<const char*>(kb), sizeof kb);
    } else if (PyLong_CheckExact(v)) {
        int overflow = 0;
        long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (overflow != 0 || (x == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            return wf_pack_pickled(buf, v);  // >64-bit int: rare
        }
        buf.push_back(static_cast<char>(WT_I64));
        wf_put_u64(buf, static_cast<uint64_t>(x));
    } else if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        buf.push_back(static_cast<char>(WT_F64));
        uint64_t bits;
        std::memcpy(&bits, &d, 8);
        wf_put_u64(buf, bits);
    } else if (PyUnicode_CheckExact(v)) {
        Py_ssize_t n;
        const char* s = PyUnicode_AsUTF8AndSize(v, &n);
        if (s == nullptr) return false;
        if (static_cast<size_t>(n) > kWfMaxLen) {
            PyErr_SetString(PyExc_ValueError,
                            "value too large for update frame");
            return false;
        }
        if (intern != nullptr && static_cast<size_t>(n) <= kWfInternMaxLen) {
            // the decoder appends the same strings to its table in the
            // same order, so the insert-on-first-sight protocol below
            // must stay byte-symmetric with the WT_STR decode path
            std::string k(s, static_cast<size_t>(n));
            auto it = intern->map.find(k);
            if (it != intern->map.end()) {
                buf.push_back(static_cast<char>(WT_STRREF));
                wf_put_varint(buf, it->second);
                return true;
            }
            if (intern->map.size() < kWfInternCap) {
                intern->map.emplace(
                    std::move(k),
                    static_cast<uint32_t>(intern->map.size()));
            }
        }
        buf.push_back(static_cast<char>(WT_STR));
        wf_put_u32(buf, static_cast<uint32_t>(n));
        buf.append(s, static_cast<size_t>(n));
    } else if (PyBytes_CheckExact(v)) {
        char* p;
        Py_ssize_t n;
        if (PyBytes_AsStringAndSize(v, &p, &n) < 0) return false;
        if (static_cast<size_t>(n) > kWfMaxLen) {
            PyErr_SetString(PyExc_ValueError,
                            "value too large for update frame");
            return false;
        }
        buf.push_back(static_cast<char>(WT_BYTES));
        wf_put_u32(buf, static_cast<uint32_t>(n));
        buf.append(p, static_cast<size_t>(n));
    } else if (PyTuple_CheckExact(v) && PyTuple_GET_SIZE(v) < 255) {
        buf.push_back(static_cast<char>(WT_TUPLE));
        buf.push_back(static_cast<char>(PyTuple_GET_SIZE(v)));
        for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(v); i++) {
            if (!wf_pack_value(buf, PyTuple_GET_ITEM(v, i), intern))
                return false;
        }
    } else {
        return wf_pack_pickled(buf, v);  // datetime/ndarray/Json/...
    }
    return true;
}

// shared row codec: 16-byte key + count byte + tagged values (0xFF =
// whole-values pickle).  Both frame formats (updates, kv pairs) are this
// row plus format-specific fields, so there is exactly ONE copy of the
// value-encoding logic.
bool wf_pack_row(std::string& buf, PyObject* key, PyObject* values,
                 WfIntern* intern) {
    uint8_t kb[16];
    if (pt_long_as_bytes_unsigned(key, kb, sizeof kb) < 0) {
        // 3.13+ reports too-large keys without raising; keys are 128-bit
        // by contract so surface a clean error either way
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "key does not fit 16 bytes");
        return false;
    }
    buf.append(reinterpret_cast<const char*>(kb), sizeof kb);
    if (PyTuple_CheckExact(values) && PyTuple_GET_SIZE(values) < 255) {
        buf.push_back(static_cast<char>(PyTuple_GET_SIZE(values)));
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(values); j++) {
            if (!wf_pack_value(buf, PyTuple_GET_ITEM(values, j), intern))
                return false;
        }
        return true;
    }
    buf.push_back(static_cast<char>(0xFF));
    return wf_pack_pickled(buf, values);
}


// shared frame encoder: appends [u32 count] rows to `buf`; false with
// exception set on failure (buf may hold a torn frame — callers discard)
bool wf_pack_updates_frame(std::string& buf, PyObject* batch,
                           WfIntern* intern) {
    PyObject* seq = PySequence_Fast(batch, "pack_updates expects a sequence");
    if (seq == nullptr) return false;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    if (buf.capacity() - buf.size() < static_cast<size_t>(n) * 48 + 8)
        buf.reserve(buf.size() + static_cast<size_t>(n) * 48 + 8);
    wf_put_u32(buf, static_cast<uint32_t>(n));
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            Py_DECREF(seq);
            return false;
        }
        if (!wf_pack_row(buf, PyTuple_GET_ITEM(u, 0),
                         PyTuple_GET_ITEM(u, 1), intern)) {
            Py_DECREF(seq);
            return false;
        }
        long long d = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
        if (d == -1 && PyErr_Occurred()) {
            Py_DECREF(seq);
            return false;
        }
        wf_put_varint(buf, d);
    }
    Py_DECREF(seq);
    return true;
}

PyObject* py_pack_updates(PyObject*, PyObject* batch) {
    std::string buf;
    WfIntern intern;
    if (!wf_pack_updates_frame(buf, batch, &intern)) return nullptr;
    return PyBytes_FromStringAndSize(buf.data(),
                                     static_cast<Py_ssize_t>(buf.size()));
}

PyObject* py_pack_updates_into(PyObject*, PyObject* args) {
    // pack_updates_into(batch, bytearray) -> appended byte count.  The
    // cluster sender threads build one coalesced transmission per peer by
    // appending frames straight into a reusable bytearray; the scratch
    // string is thread-local so its capacity persists across epochs (no
    // per-epoch allocation churn on the exchange hot path).
    PyObject* batch;
    PyObject* target;
    if (!PyArg_ParseTuple(args, "OO!:pack_updates_into", &batch,
                          &PyByteArray_Type, &target))
        return nullptr;
    static thread_local std::string buf;
    static thread_local WfIntern intern;
    buf.clear();
    // the string table is scoped to ONE frame (each frame in a coalesced
    // transmission decodes with its own fresh reader), so the map resets
    // per call even though its buckets persist for reuse
    intern.map.clear();
    if (!wf_pack_updates_frame(buf, batch, &intern)) return nullptr;
    Py_ssize_t at = PyByteArray_GET_SIZE(target);
    if (PyByteArray_Resize(target, at + static_cast<Py_ssize_t>(buf.size())) <
        0)
        return nullptr;
    std::memcpy(PyByteArray_AS_STRING(target) + at, buf.data(), buf.size());
    return PyLong_FromSsize_t(static_cast<Py_ssize_t>(buf.size()));
}

struct WfReader {
    const uint8_t* p;
    const uint8_t* end;
    bool fail = false;
    // frame string table: borrowed refs to strings decoded so far (the
    // built rows own them; decode errors abort the whole frame, so an
    // entry can never dangle while the reader is live).  Mirrors the
    // encoder's insert-on-first-sight protocol exactly.
    std::vector<PyObject*> strtab;

    bool need(size_t n) {
        // sticky: a failed length read must poison the zero-length
        // bytes() that follows it, or truncated frames decode as ''
        if (fail || static_cast<size_t>(end - p) < n) {
            fail = true;
            return false;
        }
        return true;
    }
    uint32_t u32() {
        if (!need(4)) return 0;
        uint32_t v;
        std::memcpy(&v, p, 4);
        p += 4;
        return v;
    }
    uint64_t u64() {
        if (!need(8)) return 0;
        uint64_t v;
        std::memcpy(&v, p, 8);
        p += 8;
        return v;
    }
    uint8_t u8() {
        if (!need(1)) return 0;
        return *p++;
    }
    long long varint() {
        unsigned long long v = 0;
        int shift = 0;
        while (true) {
            if (!need(1)) return 0;
            uint8_t b = *p++;
            v |= static_cast<unsigned long long>(b & 0x7F) << shift;
            if ((b & 0x80) == 0) break;
            shift += 7;
            if (shift > 63) {
                fail = true;
                return 0;
            }
        }
        return static_cast<long long>(v >> 1) ^
               -static_cast<long long>(v & 1);
    }
    const uint8_t* bytes(size_t n) {
        if (!need(n)) return nullptr;
        const uint8_t* q = p;
        p += n;
        return q;
    }
};

PyObject* wf_unpack_value(WfReader& r) {
    uint8_t tag = r.u8();
    if (r.fail) {
        PyErr_SetString(PyExc_ValueError, "truncated update frame");
        return nullptr;
    }
    switch (tag) {
        case WT_NONE:
            Py_RETURN_NONE;
        case WT_TRUE:
            Py_RETURN_TRUE;
        case WT_FALSE:
            Py_RETURN_FALSE;
        case WT_I64: {
            uint64_t v = r.u64();
            if (r.fail) break;
            return PyLong_FromLongLong(static_cast<long long>(v));
        }
        case WT_F64: {
            uint64_t bits = r.u64();
            if (r.fail) break;
            double d;
            std::memcpy(&d, &bits, 8);
            return PyFloat_FromDouble(d);
        }
        case WT_STR: {
            uint32_t n = r.u32();
            const uint8_t* s = r.bytes(n);
            if (s == nullptr) break;
            PyObject* str = PyUnicode_DecodeUTF8(
                reinterpret_cast<const char*>(s),
                static_cast<Py_ssize_t>(n), nullptr);
            // condition must match the encoder's intern gate exactly or
            // the two sides' table indices diverge silently
            if (str != nullptr && n <= kWfInternMaxLen &&
                r.strtab.size() < kWfInternCap)
                r.strtab.push_back(str);  // borrowed; rows own it
            return str;
        }
        case WT_STRREF: {
            uint64_t idx = r.varint();
            if (r.fail) break;
            if (idx >= r.strtab.size()) {
                PyErr_SetString(PyExc_ValueError,
                                "bad string ref in frame");
                return nullptr;
            }
            PyObject* str = r.strtab[static_cast<size_t>(idx)];
            Py_INCREF(str);
            return str;
        }
        case WT_BYTES: {
            uint32_t n = r.u32();
            const uint8_t* s = r.bytes(n);
            if (s == nullptr) break;
            return PyBytes_FromStringAndSize(
                reinterpret_cast<const char*>(s), static_cast<Py_ssize_t>(n));
        }
        case WT_POINTER: {
            uint8_t klen = r.u8();
            const uint8_t* kb = r.bytes(klen);
            if (kb == nullptr) break;
            PyObject* num = pt_long_from_bytes_unsigned(kb, klen);
            if (num == nullptr || g_pointer_type == nullptr) return num;
            return pointer_from_long(num);
        }
        case WT_TUPLE: {
            uint8_t arity = r.u8();
            if (r.fail) break;
            PyObject* t = PyTuple_New(arity);
            if (t == nullptr) return nullptr;
            for (uint8_t i = 0; i < arity; i++) {
                PyObject* item = wf_unpack_value(r);
                if (item == nullptr) {
                    Py_DECREF(t);
                    return nullptr;
                }
                PyTuple_SET_ITEM(t, i, item);
            }
            return t;
        }
        case WT_PICKLE: {
            uint32_t n = r.u32();
            const uint8_t* s = r.bytes(n);
            if (s == nullptr || g_pickle_loads == nullptr) break;
            PyObject* data = PyBytes_FromStringAndSize(
                reinterpret_cast<const char*>(s), static_cast<Py_ssize_t>(n));
            if (data == nullptr) return nullptr;
            PyObject* v =
                PyObject_CallFunctionObjArgs(g_pickle_loads, data, nullptr);
            Py_DECREF(data);
            return v;
        }
        default:
            PyErr_Format(PyExc_ValueError, "bad value tag %d in frame",
                         static_cast<int>(tag));
            return nullptr;
    }
    PyErr_SetString(PyExc_ValueError, "truncated update frame");
    return nullptr;
}

// returns new refs in *key_out / *values_out; false with exception set
bool wf_unpack_row(WfReader& r, PyObject** key_out, PyObject** values_out) {
    const uint8_t* kb = r.bytes(16);
    uint8_t nvals = r.u8();
    if (kb == nullptr || r.fail) {
        PyErr_SetString(PyExc_ValueError, "truncated row in frame");
        return false;
    }
    PyObject* values;
    if (nvals == 0xFF) {
        values = wf_unpack_value(r);  // whole-values pickle
    } else {
        values = PyTuple_New(nvals);
        for (uint8_t j = 0; values != nullptr && j < nvals; j++) {
            PyObject* v = wf_unpack_value(r);
            if (v == nullptr) {
                Py_DECREF(values);
                values = nullptr;
                break;
            }
            PyTuple_SET_ITEM(values, j, v);
        }
    }
    if (values == nullptr) return false;
    PyObject* num = pt_long_from_bytes_unsigned(kb, 16);
    if (num == nullptr) {
        Py_DECREF(values);
        return false;
    }
    PyObject* key = pointer_from_long(num);
    if (key == nullptr) {
        Py_DECREF(values);
        return false;
    }
    *key_out = key;
    *values_out = values;
    return true;
}

PyObject* py_unpack_updates(PyObject*, PyObject* arg) {
    // accepts any C-contiguous buffer (bytes, bytearray, memoryview): the
    // cluster reader threads decode frames from zero-copy slices of the
    // reusable receive buffer
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return nullptr;
    const char* data = static_cast<const char*>(view.buf);
    Py_ssize_t nbytes = view.len;
    if (g_update_type == nullptr || g_pointer_type == nullptr) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_RuntimeError,
                        "unpack_updates: Update/Pointer types unregistered");
        return nullptr;
    }
    WfReader r{reinterpret_cast<const uint8_t*>(data),
               reinterpret_cast<const uint8_t*>(data) + nbytes};
    uint32_t n = r.u32();
    if (r.fail) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "truncated update frame");
        return nullptr;
    }
    PyObject* out = PyList_New(static_cast<Py_ssize_t>(n));
    if (out == nullptr) {
        PyBuffer_Release(&view);
        return nullptr;
    }
    for (uint32_t i = 0; i < n; i++) {
        PyObject *key, *values;
        if (!wf_unpack_row(r, &key, &values)) goto fail;
        {
            long long diff = r.varint();
            if (r.fail) {
                Py_DECREF(key);
                Py_DECREF(values);
                PyErr_SetString(PyExc_ValueError, "truncated update frame");
                goto fail;
            }
            PyObject* dobj = PyLong_FromLongLong(diff);
            if (dobj == nullptr) {
                Py_DECREF(values);
                Py_DECREF(key);
                goto fail;
            }
            // Update is a NamedTuple whose generated __new__ is a Python
            // function — calling it per row costs more than the whole
            // parse.  It adds no state beyond the tuple items, so
            // allocate the tuple subclass directly (exactly what
            // tuple.__new__ does) and steal the refs.
            PyTypeObject* ut = reinterpret_cast<PyTypeObject*>(g_update_type);
            PyObject* u = ut->tp_alloc(ut, 3);
            if (u == nullptr) {
                Py_DECREF(values);
                Py_DECREF(key);
                Py_DECREF(dobj);
                goto fail;
            }
            PyTuple_SET_ITEM(u, 0, key);
            PyTuple_SET_ITEM(u, 1, values);
            PyTuple_SET_ITEM(u, 2, dobj);
            PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), u);
        }
    }
    PyBuffer_Release(&view);
    return out;
fail:
    PyBuffer_Release(&view);
    Py_DECREF(out);
    return nullptr;
}

PyObject* py_pack_kv(PyObject*, PyObject* rows) {
    // persistence "addmany" records: (key, values) pairs in the tagged
    // binary format (pickling 2M-row chunks costs a per-row listcomp +
    // int conversions; see persistence _RecordingEvents.add_many)
    PyObject* seq = PySequence_Fast(rows, "pack_kv expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::string buf;
    buf.reserve(static_cast<size_t>(n) * 40 + 8);
    wf_put_u32(buf, static_cast<uint32_t>(n));
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* kv = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(kv) || PyTuple_GET_SIZE(kv) != 2) {
            PyErr_SetString(PyExc_TypeError, "rows must be (key, values)");
            Py_DECREF(seq);
            return nullptr;
        }
        // no interning: snapshot bytes must stay stable across releases
        // (the shared decoder accepts refs regardless)
        if (!wf_pack_row(buf, PyTuple_GET_ITEM(kv, 0),
                         PyTuple_GET_ITEM(kv, 1), nullptr)) {
            Py_DECREF(seq);
            return nullptr;
        }
    }
    Py_DECREF(seq);
    return PyBytes_FromStringAndSize(buf.data(),
                                     static_cast<Py_ssize_t>(buf.size()));
}

PyObject* py_unpack_kv(PyObject*, PyObject* arg) {
    char* data;
    Py_ssize_t nbytes;
    if (PyBytes_AsStringAndSize(arg, &data, &nbytes) < 0) return nullptr;
    if (g_pointer_type == nullptr) {
        PyErr_SetString(PyExc_RuntimeError, "Pointer type unregistered");
        return nullptr;
    }
    WfReader r{reinterpret_cast<const uint8_t*>(data),
               reinterpret_cast<const uint8_t*>(data) + nbytes};
    uint32_t n = r.u32();
    if (r.fail) {
        PyErr_SetString(PyExc_ValueError, "truncated kv frame");
        return nullptr;
    }
    PyObject* out = PyList_New(static_cast<Py_ssize_t>(n));
    if (out == nullptr) return nullptr;
    for (uint32_t i = 0; i < n; i++) {
        PyObject *key, *values;
        if (!wf_unpack_row(r, &key, &values)) goto fail;
        {
            PyObject* kv = PyTuple_New(2);
            if (kv == nullptr) {
                Py_DECREF(values);
                Py_DECREF(key);
                goto fail;
            }
            PyTuple_SET_ITEM(kv, 0, key);
            PyTuple_SET_ITEM(kv, 1, values);
            PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), kv);
        }
    }
    return out;
fail:
    Py_DECREF(out);
    return nullptr;
}

PyObject* py_capture_batch(PyObject*, PyObject* args) {
    // CaptureNode epoch pass: stream.append((key, values, time, diff))
    // and rows[key] = values / del rows[key] for every update, in one C
    // loop — the per-row Python version dominates capture-terminated
    // pipelines (the select+filter bench spent more time here than in
    // the expression VM).
    PyObject *stream, *rows, *batch, *time_obj;
    if (!PyArg_ParseTuple(args, "OOOO", &stream, &rows, &batch, &time_obj))
        return nullptr;
    if (!PyList_Check(stream) || !PyDict_Check(rows)) {
        PyErr_SetString(PyExc_TypeError, "capture state must be list+dict");
        return nullptr;
    }
    PyObject* seq = PySequence_Fast(batch, "capture expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            Py_DECREF(seq);
            return nullptr;
        }
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        PyObject* diff = PyTuple_GET_ITEM(u, 2);
        PyObject* rec = PyTuple_Pack(4, key, values, time_obj, diff);
        if (rec == nullptr || PyList_Append(stream, rec) < 0) {
            Py_XDECREF(rec);
            Py_DECREF(seq);
            return nullptr;
        }
        Py_DECREF(rec);
        long long d = PyLong_AsLongLong(diff);
        if (d == -1 && PyErr_Occurred()) {
            Py_DECREF(seq);
            return nullptr;
        }
        if (d > 0) {
            if (PyDict_SetItem(rows, key, values) < 0) {
                Py_DECREF(seq);
                return nullptr;
            }
        } else {
            if (PyDict_DelItem(rows, key) < 0) PyErr_Clear();
        }
    }
    Py_DECREF(seq);
    Py_RETURN_NONE;
}

// ---- per-stage latency instrumentation -------------------------------
//
// Streaming-safe latency histograms for the event-driven scheduler:
// log-bucketed (8 sub-buckets per octave, ~12% resolution) so a
// long-running pipeline aggregates unbounded samples in fixed memory
// and p50/p95/p99 stay queryable at any moment.  Buckets are atomics:
// connector reader threads, worker threads and the monitoring server
// touch the same histogram concurrently.  The bucket function is
// mirrored by the Python fallback in internals/monitoring.py.

constexpr int kLatBuckets = 488;  // idx(2^62 ns) == 487

struct LatHist {
    std::atomic<uint64_t> buckets[kLatBuckets];
    std::atomic<uint64_t> count{0};
    std::atomic<int64_t> sum{0};
    std::atomic<int64_t> maxv{0};
    LatHist() {
        for (auto& b : buckets) b.store(0, std::memory_order_relaxed);
    }
};

inline int lat_bucket(int64_t ns) {
    if (ns < 16) return ns < 0 ? 0 : (int)ns;
    int msb = 63 - __builtin_clzll((uint64_t)ns);
    return 16 + (msb - 4) * 8 + (int)((ns >> (msb - 3)) & 7);
}

// geometric bucket midpoint (exact for the 16 unit buckets)
inline int64_t lat_bucket_rep(int idx) {
    if (idx < 16) return idx;
    int msb = 4 + (idx - 16) / 8;
    int sub = (idx - 16) % 8;
    int64_t lo = (1LL << msb) | ((int64_t)sub << (msb - 3));
    return lo + (1LL << (msb - 3)) / 2;
}

int64_t mono_ns_now() {
    return (int64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

void lat_hist_free(PyObject* cap) {
    delete static_cast<LatHist*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.lathist"));
}

PyObject* py_monotonic_ns(PyObject*, PyObject*) {
    return PyLong_FromLongLong(mono_ns_now());
}

PyObject* py_hist_new(PyObject*, PyObject*) {
    return PyCapsule_New(new LatHist(), "pathway_tpu.lathist",
                         lat_hist_free);
}

inline LatHist* lat_hist_from(PyObject* cap) {
    return static_cast<LatHist*>(
        PyCapsule_GetPointer(cap, "pathway_tpu.lathist"));
}

PyObject* py_hist_record(PyObject*, PyObject* args) {
    PyObject* cap;
    long long ns;
    if (!PyArg_ParseTuple(args, "OL", &cap, &ns)) return nullptr;
    LatHist* h = lat_hist_from(cap);
    if (h == nullptr) return nullptr;
    if (ns < 0) ns = 0;
    h->buckets[lat_bucket(ns)].fetch_add(1, std::memory_order_relaxed);
    h->count.fetch_add(1, std::memory_order_relaxed);
    h->sum.fetch_add(ns, std::memory_order_relaxed);
    int64_t prev = h->maxv.load(std::memory_order_relaxed);
    while (ns > prev &&
           !h->maxv.compare_exchange_weak(prev, ns,
                                          std::memory_order_relaxed)) {
    }
    Py_RETURN_NONE;
}

PyObject* py_hist_snapshot(PyObject*, PyObject* args) {
    PyObject* cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return nullptr;
    LatHist* h = lat_hist_from(cap);
    if (h == nullptr) return nullptr;
    uint64_t counts[kLatBuckets];
    uint64_t total = 0;
    for (int i = 0; i < kLatBuckets; i++) {
        counts[i] = h->buckets[i].load(std::memory_order_relaxed);
        total += counts[i];
    }
    int64_t sum = h->sum.load(std::memory_order_relaxed);
    int64_t maxv = h->maxv.load(std::memory_order_relaxed);
    const double qs[3] = {0.50, 0.95, 0.99};
    double out[3] = {0.0, 0.0, 0.0};
    if (total > 0) {
        for (int q = 0; q < 3; q++) {
            double target = qs[q] * (double)total;
            uint64_t cum = 0;
            for (int i = 0; i < kLatBuckets; i++) {
                cum += counts[i];
                if ((double)cum >= target && cum > 0) {
                    int64_t rep = lat_bucket_rep(i);
                    out[q] = (double)(rep < maxv ? rep : maxv);
                    break;
                }
            }
        }
    }
    return Py_BuildValue(
        "{s:K,s:L,s:L,s:d,s:d,s:d}", "count", (unsigned long long)total,
        "sum_ns", (long long)sum, "max_ns", (long long)maxv, "p50_ns",
        out[0], "p95_ns", out[1], "p99_ns", out[2]);
}

// --------------------------------------------------------------------------
// columnar epoch frames
//
// A Frame is one epoch delta held as contiguous typed columns plus an
// interned string pool — the role of the reference's batched
// arrangements (Rust differential operates on sorted (data, time, diff)
// batches, never on per-row boxed values).  Connectors build frames
// straight from the input bytes (frame_parse_jsonl), operators fold them
// with vectorized kernels (frame_groupby_partials, frame_route_split,
// frame_project, frame_filter), and the exchange layer ships the column
// buffers as one blob per (peer, slot) with a transmission-scoped string
// pool (frame_pack / frame_unpack).  Any value outside the typed set
// (nested tuples, ndarrays, ERROR sentinels, >64-bit ints) keeps the
// whole batch on the row-at-a-time path: frames are an optimization of
// REPRESENTATION only, every kernel is behaviour-identical to its row
// counterpart and Unsupported/None means "caller falls back".
//
// Keys carry a LAZY representation: connector rows are keyed as
// blake2b(prefix..., seq + offset) (see hash_prefix_ints), so a frame
// can hold just the prefix hash STATE plus the int64 seqs — 8 bytes a
// row instead of 16, and no per-row blake2b until something actually
// needs the digests (positional groupby/route never does).

enum FrameTag : uint8_t {
    CF_I64 = 1,
    CF_F64 = 2,
    CF_STR = 3,   // u32 index into the frame string pool
    CF_BOOL = 4,
};

struct FrameCol {
    uint8_t tag = 0;
    std::vector<int64_t> i64;
    std::vector<double> f64;
    std::vector<uint32_t> sidx;
    std::vector<uint8_t> b8;
    std::vector<uint8_t> valid;  // empty == every row valid (non-None)

    bool is_valid(size_t i) const { return valid.empty() || valid[i] != 0; }
    size_t length() const {
        switch (tag) {
            case CF_I64: return i64.size();
            case CF_F64: return f64.size();
            case CF_STR: return sidx.size();
            case CF_BOOL: return b8.size();
            default: return 0;
        }
    }
    void reserve(size_t n) {
        switch (tag) {
            case CF_I64: i64.reserve(n); break;
            case CF_F64: f64.reserve(n); break;
            case CF_STR: sidx.reserve(n); break;
            case CF_BOOL: b8.reserve(n); break;
            default: break;
        }
    }
    // append a None cell (data slot is a zero placeholder)
    void push_null() {
        size_t len = length();
        if (valid.empty()) valid.assign(len, 1);
        valid.push_back(0);
        switch (tag) {
            case CF_I64: i64.push_back(0); break;
            case CF_F64: f64.push_back(0.0); break;
            case CF_STR: sidx.push_back(0); break;
            case CF_BOOL: b8.push_back(0); break;
            default: break;
        }
    }
    void push_valid_mark() {
        if (!valid.empty()) valid.push_back(1);
    }
    void copy_cell_from(const FrameCol& src, size_t i) {
        if (!src.is_valid(i)) {
            push_null();
            return;
        }
        switch (tag) {
            case CF_I64: i64.push_back(src.i64[i]); break;
            case CF_F64: f64.push_back(src.f64[i]); break;
            case CF_STR: sidx.push_back(src.sidx[i]); break;
            case CF_BOOL: b8.push_back(src.b8[i]); break;
            default: break;
        }
        push_valid_mark();
    }
    size_t nbytes() const {
        return i64.size() * 8 + f64.size() * 8 + sidx.size() * 4 +
               b8.size() + valid.size();
    }
};

struct Frame {
    int64_t n_rows = 0;
    std::vector<FrameCol> cols;
    std::vector<PyObject*> pool;  // owned PyUnicode, deduplicated

    bool keys_lazy = false;
    std::vector<uint8_t> keyb;        // 16 * n_rows when !keys_lazy
    pwnative::Blake2bState key_base;  // salted + prefix-fed when keys_lazy
    int64_t key_offset = 0;
    std::vector<int64_t> key_seqs;    // n_rows when keys_lazy

    bool all_plus = true;
    std::vector<int8_t> diffs;  // n_rows when !all_plus

    ~Frame() {
        for (PyObject* s : pool) Py_XDECREF(s);
    }
    long long diff_at(size_t i) const {
        return all_plus ? 1 : (long long)diffs[i];
    }
    void key_digest(size_t i, uint8_t out[16]) const {
        if (!keys_lazy) {
            std::memcpy(out, keyb.data() + 16 * i, 16);
            return;
        }
        Hasher h;
        h.S = key_base;
        feed_small_int(h, key_seqs[(size_t)i] + key_offset);
        pwnative::blake2b_final(&h.S, out);
    }
    // force the digest representation (needed for key grouping/routing
    // and for ordering-independent consumers of int keys)
    void materialize_keys() {
        if (!keys_lazy) return;
        keyb.resize((size_t)n_rows * 16);
        for (int64_t i = 0; i < n_rows; i++) {
            Hasher h;
            h.S = key_base;
            feed_small_int(h, key_seqs[(size_t)i] + key_offset);
            pwnative::blake2b_final(&h.S, keyb.data() + 16 * (size_t)i);
        }
        keys_lazy = false;
        key_seqs.clear();
        key_seqs.shrink_to_fit();
    }
    size_t nbytes() const {
        size_t n = sizeof(Frame) + keyb.size() + key_seqs.size() * 8 +
                   diffs.size();
        for (const FrameCol& c : cols) n += c.nbytes();
        for (PyObject* s : pool) {
            Py_ssize_t sl;
            // utf8 cache is populated for pool strings (built from utf8)
            if (PyUnicode_AsUTF8AndSize(s, &sl) != nullptr)
                n += (size_t)sl + 8;
            else
                PyErr_Clear();
        }
        return n;
    }
    // new empty frame shaped like this one (shared pool, same col tags,
    // same key representation); used by slice/route_split/filter
    Frame* like(bool share_pool = true) const {
        Frame* f = new Frame();
        f->cols.resize(cols.size());
        for (size_t c = 0; c < cols.size(); c++) f->cols[c].tag = cols[c].tag;
        if (share_pool) {
            f->pool = pool;
            for (PyObject* s : f->pool) Py_INCREF(s);
        }
        f->keys_lazy = keys_lazy;
        f->key_base = key_base;
        f->key_offset = key_offset;
        f->all_plus = all_plus;
        return f;
    }
    void append_row_from(const Frame& src, size_t i) {
        for (size_t c = 0; c < cols.size(); c++)
            cols[c].copy_cell_from(src.cols[c], i);
        if (keys_lazy) {
            key_seqs.push_back(src.key_seqs[i]);
        } else {
            keyb.insert(keyb.end(), src.keyb.begin() + 16 * i,
                        src.keyb.begin() + 16 * (i + 1));
        }
        if (!all_plus) diffs.push_back(src.diffs[i]);
        n_rows++;
    }
    // new ref or nullptr; cell must be valid
    PyObject* cell_object(size_t c, size_t i) const {
        const FrameCol& col = cols[c];
        if (!col.is_valid(i)) Py_RETURN_NONE;
        switch (col.tag) {
            case CF_I64: return PyLong_FromLongLong(col.i64[i]);
            case CF_F64: return PyFloat_FromDouble(col.f64[i]);
            case CF_STR: {
                PyObject* s = pool[col.sidx[i]];
                Py_INCREF(s);
                return s;
            }
            case CF_BOOL: return PyBool_FromLong(col.b8[i]);
            default:
                PyErr_SetString(g_unsupported, "bad column tag");
                return nullptr;
        }
    }
};

const char kFrameCap[] = "pathway_tpu.frame";

void frame_cap_free(PyObject* cap) {
    delete static_cast<Frame*>(PyCapsule_GetPointer(cap, kFrameCap));
}

Frame* frame_arg(PyObject* cap) {
    return static_cast<Frame*>(PyCapsule_GetPointer(cap, kFrameCap));
}

PyObject* frame_to_capsule(Frame* f) {
    PyObject* cap = PyCapsule_New(f, kFrameCap, frame_cap_free);
    if (cap == nullptr) delete f;
    return cap;
}

// pool builder: dedup by utf8 bytes during frame construction
struct FramePoolBuilder {
    std::unordered_map<std::string, uint32_t> map;
    // takes a NEW reference to store (steals on success)
    int64_t intern(Frame* f, PyObject* str, const char* u8, size_t n) {
        auto it = map.find(std::string(u8, n));
        if (it != map.end()) {
            Py_DECREF(str);
            return (int64_t)it->second;
        }
        uint32_t idx = (uint32_t)f->pool.size();
        if (idx == UINT32_MAX) {
            Py_DECREF(str);
            return -1;
        }
        f->pool.push_back(str);
        map.emplace(std::string(u8, n), idx);
        return (int64_t)idx;
    }
};

PyObject* py_frame_len(PyObject*, PyObject* cap) {
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    return PyLong_FromLongLong(f->n_rows);
}

PyObject* py_frame_nbytes(PyObject*, PyObject* cap) {
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    return PyLong_FromSize_t(f->nbytes());
}

PyObject* py_frame_ncols(PyObject*, PyObject* cap) {
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    return PyLong_FromSize_t(f->cols.size());
}

PyObject* py_frame_all_plus(PyObject*, PyObject* cap) {
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    return PyBool_FromLong(f->all_plus ? 1 : 0);
}

PyObject* py_frame_from_updates(PyObject*, PyObject* batch) {
    // strict columnarization of an update list: every value must be in
    // the typed set and every column type-stable, else Unsupported (the
    // caller keeps the row representation — NEVER a lossy conversion)
    PyObject* seq =
        PySequence_Fast(batch, "frame_from_updates expects a sequence");
    if (seq == nullptr) return nullptr;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    std::unique_ptr<Frame> f(new Frame());
    FramePoolBuilder pb;
    Py_ssize_t ncols = -1;
    bool unsupported = false;
    for (Py_ssize_t i = 0; i < n && !unsupported; i++) {
        PyObject* u = PySequence_Fast_GET_ITEM(seq, i);
        if (!PyTuple_Check(u) || PyTuple_GET_SIZE(u) != 3) {
            Py_DECREF(seq);
            PyErr_SetString(PyExc_TypeError, "updates must be 3-tuples");
            return nullptr;
        }
        PyObject* key = PyTuple_GET_ITEM(u, 0);
        PyObject* values = PyTuple_GET_ITEM(u, 1);
        if (!PyTuple_CheckExact(values)) {
            unsupported = true;
            break;
        }
        if (ncols == -1) {
            ncols = PyTuple_GET_SIZE(values);
            f->cols.resize((size_t)ncols);
            for (FrameCol& c : f->cols) c.reserve((size_t)n);
            f->keyb.reserve((size_t)n * 16);
        } else if (PyTuple_GET_SIZE(values) != ncols) {
            unsupported = true;
            break;
        }
        uint8_t kb[16];
        if (!PyLong_Check(key) || pt_long_as_bytes_unsigned(key, kb, 16) < 0) {
            PyErr_Clear();
            unsupported = true;  // negative / >128-bit / non-int key
            break;
        }
        long long d = PyLong_AsLongLong(PyTuple_GET_ITEM(u, 2));
        if (d == -1 && PyErr_Occurred()) {
            PyErr_Clear();
            unsupported = true;
            break;
        }
        if (d < INT8_MIN || d > INT8_MAX) {
            unsupported = true;
            break;
        }
        for (Py_ssize_t c = 0; c < ncols && !unsupported; c++) {
            FrameCol& col = f->cols[(size_t)c];
            PyObject* v = PyTuple_GET_ITEM(values, c);
            if (v == Py_None) {
                if (col.tag == 0) {
                    // type still unknown: count as null, backfilled when
                    // (if ever) the column discovers its type
                    size_t len = col.valid.size();
                    if (col.valid.empty() && i > 0)
                        col.valid.assign((size_t)i, 0), len = (size_t)i;
                    col.valid.push_back(0);
                    (void)len;
                    continue;
                }
                col.push_null();
                continue;
            }
            uint8_t want;
            if (PyBool_Check(v)) {
                want = CF_BOOL;
            } else if (g_pointer_type != nullptr &&
                       PyObject_TypeCheck(
                           v, reinterpret_cast<PyTypeObject*>(
                                  g_pointer_type))) {
                unsupported = true;  // Pointer cells lose identity
                break;
            } else if (PyLong_CheckExact(v)) {
                want = CF_I64;
            } else if (PyFloat_CheckExact(v)) {
                want = CF_F64;
            } else if (PyUnicode_CheckExact(v)) {
                want = CF_STR;
            } else {
                unsupported = true;  // tuple/bytes/ndarray/ERROR/...
                break;
            }
            if (col.tag == 0) {
                // column discovers its type: backfill earlier nulls
                col.tag = want;
                size_t nulls = col.valid.size();
                switch (want) {
                    case CF_I64: col.i64.assign(nulls, 0); break;
                    case CF_F64: col.f64.assign(nulls, 0.0); break;
                    case CF_STR: col.sidx.assign(nulls, 0); break;
                    case CF_BOOL: col.b8.assign(nulls, 0); break;
                }
            } else if (col.tag != want) {
                unsupported = true;  // mixed column
                break;
            }
            switch (want) {
                case CF_I64: {
                    int overflow = 0;
                    long long x = PyLong_AsLongLongAndOverflow(v, &overflow);
                    if (overflow != 0 || (x == -1 && PyErr_Occurred())) {
                        PyErr_Clear();
                        unsupported = true;
                        break;
                    }
                    col.i64.push_back(x);
                    break;
                }
                case CF_F64:
                    col.f64.push_back(PyFloat_AS_DOUBLE(v));
                    break;
                case CF_STR: {
                    Py_ssize_t sl;
                    const char* s = PyUnicode_AsUTF8AndSize(v, &sl);
                    if (s == nullptr) {
                        PyErr_Clear();
                        unsupported = true;
                        break;
                    }
                    Py_INCREF(v);
                    int64_t idx = pb.intern(f.get(), v, s, (size_t)sl);
                    if (idx < 0) {
                        unsupported = true;
                        break;
                    }
                    col.sidx.push_back((uint32_t)idx);
                    break;
                }
                case CF_BOOL:
                    col.b8.push_back(v == Py_True ? 1 : 0);
                    break;
            }
            if (!unsupported) col.push_valid_mark();
        }
        if (unsupported) break;
        f->keyb.insert(f->keyb.end(), kb, kb + 16);
        if (d != 1 && f->all_plus) {
            f->all_plus = false;
            f->diffs.assign((size_t)i, 1);
        }
        if (!f->all_plus) f->diffs.push_back((int8_t)d);
        f->n_rows++;
    }
    Py_DECREF(seq);
    if (unsupported) {
        if (!PyErr_Occurred())
            PyErr_SetString(g_unsupported, "batch not columnarizable");
        return nullptr;
    }
    if (ncols == -1) f->cols.clear();  // empty batch: zero columns
    // columns that stayed all-None: give them a concrete tag so every
    // kernel can treat tag as trusted
    for (FrameCol& c : f->cols) {
        if (c.tag == 0) {
            c.tag = CF_I64;
            c.i64.assign(c.valid.size(), 0);
        }
    }
    return frame_to_capsule(f.release());
}

PyObject* py_frame_to_updates(PyObject*, PyObject* cap) {
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    if (g_update_type == nullptr || g_pointer_type == nullptr) {
        PyErr_SetString(PyExc_RuntimeError,
                        "frame_to_updates: Update/Pointer unregistered");
        return nullptr;
    }
    PyObject* out = PyList_New((Py_ssize_t)f->n_rows);
    if (out == nullptr) return nullptr;
    size_t ncols = f->cols.size();
    for (int64_t i = 0; i < f->n_rows; i++) {
        uint8_t kb[16];
        f->key_digest((size_t)i, kb);
        PyObject* num = pt_long_from_bytes_unsigned(kb, 16);
        PyObject* key = pointer_from_long(num);
        if (key == nullptr) goto fail;
        {
            PyObject* values = PyTuple_New((Py_ssize_t)ncols);
            if (values == nullptr) {
                Py_DECREF(key);
                goto fail;
            }
            for (size_t c = 0; c < ncols; c++) {
                PyObject* v = f->cell_object(c, (size_t)i);
                if (v == nullptr) {
                    Py_DECREF(values);
                    Py_DECREF(key);
                    goto fail;
                }
                PyTuple_SET_ITEM(values, (Py_ssize_t)c, v);
            }
            PyObject* u =
                make_update(g_update_type, key, values, f->diff_at((size_t)i));
            Py_DECREF(key);
            Py_DECREF(values);
            if (u == nullptr) goto fail;
            PyList_SET_ITEM(out, (Py_ssize_t)i, u);
        }
    }
    return out;
fail:
    Py_DECREF(out);
    return nullptr;
}

PyObject* py_frame_slice(PyObject*, PyObject* args) {
    PyObject* cap;
    long long start, stop;
    if (!PyArg_ParseTuple(args, "OLL", &cap, &start, &stop)) return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    if (start < 0) start = 0;
    if (stop > f->n_rows) stop = f->n_rows;
    if (stop < start) stop = start;
    std::unique_ptr<Frame> out(f->like());
    for (size_t c = 0; c < f->cols.size(); c++)
        out->cols[c].reserve((size_t)(stop - start));
    for (long long i = start; i < stop; i++)
        out->append_row_from(*f, (size_t)i);
    return frame_to_capsule(out.release());
}

// ---- JSONL -> frame parser -------------------------------------------
//
// frame_parse_jsonl(data, plan, prefix, seq_start, seq_step, key_offset)
// parses a block of complete JSONL object lines straight into a frame:
// one pass over the bytes, zero per-row Python objects, lazy keys
// carrying just (prefix-hash state, line seq).  Strictly conservative:
// ANY construct whose semantics could diverge from the
// json.loads + coerce_rows row path (escapes, nested values, big ints,
// type/plan mismatches, malformed lines) returns None and the caller
// re-parses the whole block on the existing path.  Behaviour parity is
// therefore exact by construction — this parser only accepts inputs
// where the two paths provably agree.

struct FrameDefCell {
    bool is_null = true;
    int64_t i = 0;
    double d = 0.0;
    uint32_t s = 0;
    uint8_t b = 0;
};

inline const char* fj_skip_ws(const char* p, const char* end) {
    while (p < end &&
           (*p == ' ' || *p == '\t' || *p == '\r')) p++;
    return p;
}

// strict JSON number grammar; returns past-the-end or nullptr
const char* fj_scan_number(const char* p, const char* end, bool* is_float) {
    *is_float = false;
    if (p < end && *p == '-') p++;
    if (p >= end || *p < '0' || *p > '9') return nullptr;
    if (*p == '0') {
        p++;
    } else {
        while (p < end && *p >= '0' && *p <= '9') p++;
    }
    if (p < end && *p == '.') {
        *is_float = true;
        p++;
        if (p >= end || *p < '0' || *p > '9') return nullptr;
        while (p < end && *p >= '0' && *p <= '9') p++;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
        *is_float = true;
        p++;
        if (p < end && (*p == '+' || *p == '-')) p++;
        if (p >= end || *p < '0' || *p > '9') return nullptr;
        while (p < end && *p >= '0' && *p <= '9') p++;
    }
    return p;
}

// string body scan: [p, returned) is the content, quote consumed.
// Escapes and raw control bytes bail (nullptr) — json.loads handles
// them; this fast path only takes the overwhelmingly common clean case.
const char* fj_scan_string(const char* p, const char* end,
                           const char** content_end) {
    const char* s = p;
    while (p < end) {
        unsigned char c = (unsigned char)*p;
        if (c == '"') {
            *content_end = p;
            return p + 1;
        }
        if (c == '\\' || c < 0x20) return nullptr;
        p++;
    }
    (void)s;
    return nullptr;
}

PyObject* py_frame_parse_jsonl(PyObject*, PyObject* args) {
    PyObject *data_obj, *plan, *prefix;
    long long seq_start, seq_step, key_offset;
    if (!PyArg_ParseTuple(args, "OOO!LLL", &data_obj, &plan, &PyTuple_Type,
                          &prefix, &seq_start, &seq_step, &key_offset))
        return nullptr;
    char* data;
    Py_ssize_t nbytes;
    if (PyBytes_AsStringAndSize(data_obj, &data, &nbytes) < 0) return nullptr;

    // plan: (name, default, code) per column — same triples coerce_rows
    // takes, so defaults coerce identically
    PyObject* plan_seq = PySequence_Fast(plan, "plan must be a sequence");
    if (plan_seq == nullptr) return nullptr;
    Py_ssize_t ncols = PySequence_Fast_GET_SIZE(plan_seq);

    std::unique_ptr<Frame> f(new Frame());
    f->cols.resize((size_t)ncols);
    FramePoolBuilder pb;
    std::vector<std::string> names((size_t)ncols);
    std::vector<FrameDefCell> defaults((size_t)ncols);
    bool fallback = false;
    for (Py_ssize_t c = 0; c < ncols && !fallback; c++) {
        PyObject* item = PySequence_Fast_GET_ITEM(plan_seq, c);
        if (!PyTuple_Check(item) || PyTuple_GET_SIZE(item) != 3) {
            Py_DECREF(plan_seq);
            PyErr_SetString(PyExc_TypeError, "plan items must be 3-tuples");
            return nullptr;
        }
        PyObject* name = PyTuple_GET_ITEM(item, 0);
        PyObject* dflt = PyTuple_GET_ITEM(item, 1);
        long code = PyLong_AsLong(PyTuple_GET_ITEM(item, 2));
        if (code == -1 && PyErr_Occurred()) {
            Py_DECREF(plan_seq);
            return nullptr;
        }
        Py_ssize_t nl;
        const char* ns = PyUnicode_AsUTF8AndSize(name, &nl);
        if (ns == nullptr) {
            Py_DECREF(plan_seq);
            return nullptr;
        }
        names[(size_t)c].assign(ns, (size_t)nl);
        // key names containing quotes/backslashes would never byte-match
        // the escaped form in the JSON text
        if (names[(size_t)c].find('"') != std::string::npos ||
            names[(size_t)c].find('\\') != std::string::npos) {
            fallback = true;
            break;
        }
        uint8_t tag;
        switch (code) {
            case CO_INT: tag = CF_I64; break;
            case CO_FLOAT: tag = CF_F64; break;
            case CO_STR: tag = CF_STR; break;
            case CO_BOOL: tag = CF_BOOL; break;
            default:
                fallback = true;  // CO_ANY columns stay on the row path
                tag = 0;
                break;
        }
        if (fallback) break;
        f->cols[(size_t)c].tag = tag;
        FrameDefCell& dc = defaults[(size_t)c];
        if (dflt == Py_None) {
            dc.is_null = true;
        } else {
            // run the default through the exact coercer, then require the
            // result to be natively storable
            PyObject* cv = coerce_one(dflt, (int)code);
            if (cv == nullptr) {
                Py_DECREF(plan_seq);
                return nullptr;
            }
            dc.is_null = false;
            if (tag == CF_BOOL && PyBool_Check(cv)) {
                dc.b = cv == Py_True ? 1 : 0;
            } else if (tag == CF_I64 && PyLong_CheckExact(cv)) {
                int overflow = 0;
                dc.i = PyLong_AsLongLongAndOverflow(cv, &overflow);
                if (overflow != 0 || (dc.i == -1 && PyErr_Occurred())) {
                    PyErr_Clear();
                    fallback = true;
                }
            } else if (tag == CF_F64 && PyFloat_CheckExact(cv)) {
                dc.d = PyFloat_AS_DOUBLE(cv);
            } else if (tag == CF_STR && PyUnicode_CheckExact(cv)) {
                Py_ssize_t sl;
                const char* s = PyUnicode_AsUTF8AndSize(cv, &sl);
                if (s == nullptr) {
                    Py_DECREF(cv);
                    Py_DECREF(plan_seq);
                    return nullptr;
                }
                Py_INCREF(cv);
                int64_t idx = pb.intern(f.get(), cv, s, (size_t)sl);
                if (idx < 0)
                    fallback = true;
                else
                    dc.s = (uint32_t)idx;
            } else {
                fallback = true;  // coerced default escapes the typed set
            }
            Py_DECREF(cv);
        }
    }
    Py_DECREF(plan_seq);
    if (fallback) Py_RETURN_NONE;

    // key prefix hash state, computed once for the whole block
    Hasher base;
    for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(prefix); j++) {
        if (!feed(base, PyTuple_GET_ITEM(prefix, j))) {
            if (PyErr_Occurred()) return nullptr;
            Py_RETURN_NONE;  // exotic prefix type: row path keys
        }
    }
    f->keys_lazy = true;
    f->key_base = base.S;
    f->key_offset = key_offset;

    size_t est = (size_t)std::count(data, data + nbytes, '\n') + 1;
    for (FrameCol& c : f->cols) c.reserve(est);
    f->key_seqs.reserve(est);

    // per-row staging: duplicate keys overwrite (json.loads keeps the
    // last occurrence), so cells commit to the columns only at row end
    struct StageCell {
        int64_t i;
        double d;
        int64_t s;  // pool idx, or -1 null
        uint8_t b;
        uint8_t null;
    };
    std::vector<StageCell> stage((size_t)ncols);
    std::vector<int64_t> seen((size_t)ncols, -1);
    char numbuf[64];

    const char* p = data;
    const char* end = data + nbytes;
    int64_t row = 0;
    while (p < end && !fallback) {
        const char* line_end =
            static_cast<const char*>(memchr(p, '\n', (size_t)(end - p)));
        if (line_end == nullptr) line_end = end;
        const char* q = fj_skip_ws(p, line_end);
        if (q >= line_end) {
            fallback = true;  // blank/whitespace line: not one JSON object
            break;
        }
        if (*q != '{') {
            fallback = true;
            break;
        }
        q = fj_skip_ws(q + 1, line_end);
        bool first = true;
        while (!fallback) {
            if (q < line_end && *q == '}') {
                q++;
                break;
            }
            if (!first) {
                if (q >= line_end || *q != ',') {
                    fallback = true;
                    break;
                }
                q = fj_skip_ws(q + 1, line_end);
            }
            first = false;
            if (q >= line_end || *q != '"') {
                fallback = true;
                break;
            }
            const char* kend;
            const char* kq = fj_scan_string(q + 1, line_end, &kend);
            if (kq == nullptr) {
                fallback = true;
                break;
            }
            const char* kstart = q + 1;
            size_t klen = (size_t)(kend - kstart);
            q = fj_skip_ws(kq, line_end);
            if (q >= line_end || *q != ':') {
                fallback = true;
                break;
            }
            q = fj_skip_ws(q + 1, line_end);
            // match the key against the plan
            Py_ssize_t col = -1;
            for (Py_ssize_t c = 0; c < ncols; c++) {
                if (names[(size_t)c].size() == klen &&
                    std::memcmp(names[(size_t)c].data(), kstart, klen) == 0) {
                    col = c;
                    break;
                }
            }
            if (q >= line_end) {
                fallback = true;
                break;
            }
            uint8_t tag = col >= 0 ? f->cols[(size_t)col].tag : 0;
            StageCell cell{0, 0.0, -1, 0, 0};
            char vch = *q;
            if (vch == '"') {
                const char* vend;
                const char* vq = fj_scan_string(q + 1, line_end, &vend);
                if (vq == nullptr) {
                    fallback = true;
                    break;
                }
                if (col >= 0) {
                    if (tag != CF_STR) {
                        // string into a numeric/bool column: coerce_one
                        // would attempt parses — row path decides
                        fallback = true;
                        break;
                    }
                    PyObject* s = PyUnicode_DecodeUTF8(
                        q + 1, (Py_ssize_t)(vend - (q + 1)), nullptr);
                    if (s == nullptr) {
                        PyErr_Clear();
                        fallback = true;  // invalid utf-8
                        break;
                    }
                    int64_t idx =
                        pb.intern(f.get(), s, q + 1, (size_t)(vend - (q + 1)));
                    if (idx < 0) {
                        fallback = true;
                        break;
                    }
                    cell.s = idx;
                }
                q = vq;
            } else if (vch == 't' || vch == 'f') {
                const char* word = vch == 't' ? "true" : "false";
                size_t wl = vch == 't' ? 4 : 5;
                if ((size_t)(line_end - q) < wl ||
                    std::memcmp(q, word, wl) != 0) {
                    fallback = true;
                    break;
                }
                if (col >= 0) {
                    if (tag != CF_BOOL) {
                        fallback = true;  // bool survives CO_INT coercion
                        break;
                    }
                    cell.b = vch == 't' ? 1 : 0;
                }
                q += wl;
            } else if (vch == 'n') {
                if ((size_t)(line_end - q) < 4 ||
                    std::memcmp(q, "null", 4) != 0) {
                    fallback = true;
                    break;
                }
                // explicit null == missing: both take the default
                cell.null = 1;
                q += 4;
            } else if (vch == '-' || (vch >= '0' && vch <= '9')) {
                bool is_float;
                const char* nend = fj_scan_number(q, line_end, &is_float);
                if (nend == nullptr ||
                    (size_t)(nend - q) >= sizeof(numbuf)) {
                    fallback = true;
                    break;
                }
                if (col >= 0) {
                    std::memcpy(numbuf, q, (size_t)(nend - q));
                    numbuf[nend - q] = '\0';
                    if (!is_float) {
                        errno = 0;
                        char* ep = nullptr;
                        long long x = strtoll(numbuf, &ep, 10);
                        if (errno != 0 || ep != numbuf + (nend - q)) {
                            fallback = true;  // >64-bit int
                            break;
                        }
                        if (tag == CF_I64) {
                            cell.i = x;
                        } else if (tag == CF_F64) {
                            // PyNumber_Float(int64) and the C conversion
                            // both round to nearest-even
                            cell.d = (double)x;
                        } else {
                            fallback = true;
                            break;
                        }
                    } else {
                        if (tag != CF_F64) {
                            fallback = true;  // float into int col: row path
                            break;
                        }
                        // json.loads parses doubles with this exact
                        // function, so the bits match
                        char* ep = nullptr;
                        double d =
                            PyOS_string_to_double(numbuf, &ep, nullptr);
                        if (d == -1.0 && PyErr_Occurred()) {
                            PyErr_Clear();
                            fallback = true;
                            break;
                        }
                        if (ep != numbuf + (nend - q)) {
                            fallback = true;
                            break;
                        }
                        cell.d = d;
                    }
                }
                q = nend;
            } else {
                fallback = true;  // nested object/array or garbage
                break;
            }
            if (col >= 0) {
                stage[(size_t)col] = cell;
                seen[(size_t)col] = row;
            }
            q = fj_skip_ws(q, line_end);
        }
        if (fallback) break;
        q = fj_skip_ws(q, line_end);
        if (q != line_end) {
            fallback = true;  // trailing garbage after the object
            break;
        }
        // commit the staged row
        for (Py_ssize_t c = 0; c < ncols; c++) {
            FrameCol& colv = f->cols[(size_t)c];
            bool have = seen[(size_t)c] == row;
            const StageCell& cell = stage[(size_t)c];
            bool is_null = !have || cell.null ||
                           (colv.tag == CF_STR && have && !cell.null &&
                            cell.s < 0);
            if (is_null) {
                const FrameDefCell& dc = defaults[(size_t)c];
                if (dc.is_null) {
                    colv.push_null();
                } else {
                    switch (colv.tag) {
                        case CF_I64: colv.i64.push_back(dc.i); break;
                        case CF_F64: colv.f64.push_back(dc.d); break;
                        case CF_STR: colv.sidx.push_back(dc.s); break;
                        case CF_BOOL: colv.b8.push_back(dc.b); break;
                    }
                    colv.push_valid_mark();
                }
            } else {
                switch (colv.tag) {
                    case CF_I64: colv.i64.push_back(cell.i); break;
                    case CF_F64: colv.f64.push_back(cell.d); break;
                    case CF_STR:
                        colv.sidx.push_back((uint32_t)cell.s);
                        break;
                    case CF_BOOL: colv.b8.push_back(cell.b); break;
                }
                colv.push_valid_mark();
            }
        }
        f->key_seqs.push_back(seq_start + row * seq_step);
        f->n_rows++;
        row++;
        p = line_end < end ? line_end + 1 : end;
    }
    if (fallback) Py_RETURN_NONE;
    return frame_to_capsule(f.release());
}

// ---- frame groupby partials ------------------------------------------
//
// frame_groupby_partials(frame, group_idx, red_specs, error_obj)
// — byte-compatible output with groupby_partials ({gvals: (count,
// (partial, ...))}), computed from columns without building row
// objects.  The Python merge loop that folds partials into persistent
// accumulators is IDENTICAL for both entry points, so reducer semantics
// are shared by construction.  Frames cannot contain ERROR sentinels or
// exotic types (construction rejects them), which removes the poisoning
// scan the row path needs.

PyObject* py_frame_groupby_partials(PyObject*, PyObject* args) {
    PyObject *cap, *group_idx, *red_specs, *error_obj;
    if (!PyArg_ParseTuple(args, "OOOO", &cap, &group_idx, &red_specs,
                          &error_obj))
        return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    if (!PyTuple_Check(group_idx) || !PyTuple_Check(red_specs)) {
        PyErr_SetString(PyExc_TypeError, "group_idx/red_specs must be tuples");
        return nullptr;
    }
    Py_ssize_t ngroup = PyTuple_GET_SIZE(group_idx);
    std::vector<Py_ssize_t> gidx((size_t)ngroup);
    bool need_keys = false;
    for (Py_ssize_t i = 0; i < ngroup; i++) {
        gidx[(size_t)i] = PyLong_AsSsize_t(PyTuple_GET_ITEM(group_idx, i));
        if (gidx[(size_t)i] == -1 && PyErr_Occurred()) return nullptr;
        if (gidx[(size_t)i] < 0) need_keys = true;
        if (gidx[(size_t)i] >= (Py_ssize_t)f->cols.size()) {
            PyErr_SetString(g_unsupported, "group column out of range");
            return nullptr;
        }
    }
    Py_ssize_t nred = PyTuple_GET_SIZE(red_specs);
    std::vector<int> rcodes((size_t)nred);
    std::vector<std::vector<Py_ssize_t>> ridx((size_t)nred);
    for (Py_ssize_t r = 0; r < nred; r++) {
        PyObject* spec = PyTuple_GET_ITEM(red_specs, r);
        if (!PyTuple_Check(spec) || PyTuple_GET_SIZE(spec) != 2) {
            PyErr_SetString(PyExc_TypeError, "red_specs items must be pairs");
            return nullptr;
        }
        long code = PyLong_AsLong(PyTuple_GET_ITEM(spec, 0));
        if (code == -1 && PyErr_Occurred()) return nullptr;
        rcodes[(size_t)r] = (int)code;
        PyObject* idxs = PyTuple_GET_ITEM(spec, 1);
        if (!PyTuple_Check(idxs)) {
            PyErr_SetString(PyExc_TypeError, "red spec idx must be a tuple");
            return nullptr;
        }
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(idxs); j++) {
            Py_ssize_t v = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, j));
            if (v == -1 && PyErr_Occurred()) return nullptr;
            if (v >= (Py_ssize_t)f->cols.size()) {
                PyErr_SetString(g_unsupported, "reduce column out of range");
                return nullptr;
            }
            if (v < 0) need_keys = true;
            ridx[(size_t)r].push_back(v);
        }
        if (code == 1) {
            // sum-like native partial: the argument column must be
            // numeric (string "sums" concatenate — row path handles)
            uint8_t t = ridx[(size_t)r][0] < 0
                            ? (uint8_t)0
                            : f->cols[(size_t)ridx[(size_t)r][0]].tag;
            if (ridx[(size_t)r][0] < 0 || t == CF_STR) {
                PyErr_SetString(g_unsupported, "non-numeric sum column");
                return nullptr;
            }
        }
    }
    if (need_keys) f->materialize_keys();

    // staging table: group cells serialized to a byte key.  Single
    // string-column grouping (the dominant shape: wordcount, any
    // group-by-categorical) short-circuits through a pool-index table —
    // O(1) per row with zero hashing of string bytes.
    struct FPart {
        long long isum = 0;
        double dsum = 0.0;
        long long cnt = 0;
        bool seen = false;
        PyObject* msdict = nullptr;
        std::vector<MsItem> msitems;
    };
    struct FEntry {
        long long count = 0;
        int64_t first_row = 0;
        std::vector<FPart> parts;
    };
    std::vector<FEntry> entries;
    std::unordered_map<std::string, size_t> emap;
    std::vector<int64_t> ent_by_pool;
    int64_t ent_null = -1;
    bool single_str = ngroup == 1 && gidx[0] >= 0 &&
                      f->cols[(size_t)gidx[0]].tag == CF_STR;
    if (single_str) ent_by_pool.assign(f->pool.size(), -1);
    std::string gkey;
    bool fail = false;
    bool unsupported = false;

    for (int64_t i = 0; i < f->n_rows && !fail; i++) {
        long long diff = f->diff_at((size_t)i);
        size_t ei;
        if (single_str) {
            const FrameCol& gc = f->cols[(size_t)gidx[0]];
            int64_t* slot;
            if (gc.is_valid((size_t)i)) {
                slot = &ent_by_pool[gc.sidx[(size_t)i]];
            } else {
                slot = &ent_null;
            }
            if (*slot < 0) {
                *slot = (int64_t)entries.size();
                entries.emplace_back();
                entries.back().first_row = i;
                entries.back().parts.resize((size_t)nred);
            }
            ei = (size_t)*slot;
        } else {
            gkey.clear();
            for (Py_ssize_t j = 0; j < ngroup; j++) {
                Py_ssize_t ix = gidx[(size_t)j];
                if (ix < 0) {
                    gkey.push_back((char)0x10);
                    size_t at = gkey.size();
                    gkey.resize(at + 16);
                    f->key_digest((size_t)i, (uint8_t*)&gkey[at]);
                    continue;
                }
                const FrameCol& c = f->cols[(size_t)ix];
                if (!c.is_valid((size_t)i)) {
                    gkey.push_back((char)0x00);
                    continue;
                }
                switch (c.tag) {
                    case CF_I64: {
                        gkey.push_back((char)CF_I64);
                        int64_t v = c.i64[(size_t)i];
                        gkey.append((const char*)&v, 8);
                        break;
                    }
                    case CF_F64: {
                        gkey.push_back((char)CF_F64);
                        double v = c.f64[(size_t)i];
                        gkey.append((const char*)&v, 8);
                        break;
                    }
                    case CF_STR: {
                        gkey.push_back((char)CF_STR);
                        uint32_t v = c.sidx[(size_t)i];
                        gkey.append((const char*)&v, 4);
                        break;
                    }
                    case CF_BOOL:
                        gkey.push_back((char)CF_BOOL);
                        gkey.push_back((char)c.b8[(size_t)i]);
                        break;
                }
            }
            auto it = emap.find(gkey);
            if (it != emap.end()) {
                ei = it->second;
            } else {
                ei = entries.size();
                emap.emplace(gkey, ei);
                entries.emplace_back();
                entries.back().first_row = i;
                entries.back().parts.resize((size_t)nred);
            }
        }
        FEntry& ge = entries[ei];
        ge.count += diff;
        for (Py_ssize_t r = 0; r < nred && !fail; r++) {
            FPart& part = ge.parts[(size_t)r];
            int code = rcodes[(size_t)r];
            if (code == 0) continue;
            if (code == 1) {
                Py_ssize_t ix = ridx[(size_t)r][0];
                const FrameCol& c = f->cols[(size_t)ix];
                if (!c.is_valid((size_t)i)) continue;  // None: skipped
                if (c.tag == CF_F64) {
                    part.dsum += c.f64[(size_t)i] * (double)diff;
                } else {
                    long long v = c.tag == CF_I64 ? c.i64[(size_t)i]
                                                  : (long long)c.b8[(size_t)i];
                    long long term, nsum;
                    if (__builtin_mul_overflow(v, diff, &term) ||
                        __builtin_add_overflow(part.isum, term, &nsum)) {
                        unsupported = true;  // int64 overflow: row path
                        fail = true;
                        break;
                    }
                    part.isum = nsum;
                }
                part.cnt += diff;
                part.seen = true;
            } else if (code == 2) {
                // multiset partial: per-row arg tuples (scalar cells are
                // always hashable, so no hashable_fn detour)
                const std::vector<Py_ssize_t>& idxs = ridx[(size_t)r];
                PyObject* margs = PyTuple_New((Py_ssize_t)idxs.size());
                if (margs == nullptr) {
                    fail = true;
                    break;
                }
                bool cellfail = false;
                for (size_t j = 0; j < idxs.size(); j++) {
                    PyObject* cell;
                    if (idxs[j] < 0) {
                        uint8_t kb[16];
                        f->key_digest((size_t)i, kb);
                        cell = pointer_from_long(
                            pt_long_from_bytes_unsigned(kb, 16));
                    } else {
                        cell = f->cell_object((size_t)idxs[j], (size_t)i);
                    }
                    if (cell == nullptr) {
                        cellfail = true;
                        break;
                    }
                    PyTuple_SET_ITEM(margs, (Py_ssize_t)j, cell);
                }
                if (cellfail) {
                    Py_DECREF(margs);
                    fail = true;
                    break;
                }
                if (part.msdict == nullptr) {
                    part.msdict = PyDict_New();
                    if (part.msdict == nullptr) {
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                }
                PyObject* mf = PyDict_GetItemWithError(part.msdict, margs);
                if (mf == nullptr && PyErr_Occurred()) {
                    Py_DECREF(margs);
                    fail = true;
                    break;
                }
                if (mf != nullptr) {
                    size_t mi = (size_t)PyLong_AsSsize_t(mf);
                    part.msitems[mi].delta += diff;
                    Py_DECREF(margs);
                } else {
                    PyObject* mi =
                        PyLong_FromSsize_t((Py_ssize_t)part.msitems.size());
                    if (mi == nullptr ||
                        PyDict_SetItem(part.msdict, margs, mi) < 0) {
                        Py_XDECREF(mi);
                        Py_DECREF(margs);
                        fail = true;
                        break;
                    }
                    Py_DECREF(mi);
                    Py_INCREF(margs);  // msitems owns args AND h (same obj)
                    part.msitems.push_back({diff, margs, margs});
                }
            } else {
                unsupported = true;
                fail = true;
                break;
            }
        }
    }

    auto free_entries = [&entries]() {
        for (FEntry& e : entries) {
            for (FPart& p : e.parts) {
                Py_XDECREF(p.msdict);
                for (MsItem& it : p.msitems) {
                    Py_XDECREF(it.args);
                    Py_XDECREF(it.h);
                }
            }
        }
        entries.clear();
    };

    if (fail) {
        free_entries();
        if (unsupported && !PyErr_Occurred())
            PyErr_SetString(g_unsupported, "frame groupby not supported");
        return nullptr;
    }

    PyObject* out = PyDict_New();
    if (out == nullptr) {
        free_entries();
        return nullptr;
    }
    for (size_t ei = 0; ei < entries.size() && !fail; ei++) {
        FEntry& ge = entries[ei];
        // rebuild gvals from the entry's first row
        PyObject* gv = PyTuple_New(ngroup);
        if (gv == nullptr) {
            fail = true;
            break;
        }
        for (Py_ssize_t j = 0; j < ngroup && !fail; j++) {
            PyObject* cell;
            if (gidx[(size_t)j] < 0) {
                uint8_t kb[16];
                f->key_digest((size_t)ge.first_row, kb);
                cell = pointer_from_long(pt_long_from_bytes_unsigned(kb, 16));
            } else {
                cell = f->cell_object((size_t)gidx[(size_t)j],
                                      (size_t)ge.first_row);
            }
            if (cell == nullptr) {
                fail = true;
                break;
            }
            PyTuple_SET_ITEM(gv, j, cell);
        }
        if (fail) {
            Py_DECREF(gv);
            break;
        }
        PyObject* parts = PyTuple_New(nred);
        if (parts == nullptr) {
            Py_DECREF(gv);
            fail = true;
            break;
        }
        for (Py_ssize_t r = 0; r < nred && !fail; r++) {
            FPart& p = ge.parts[(size_t)r];
            PyObject* payload = nullptr;
            if (rcodes[(size_t)r] == 0) {
                payload = PyLong_FromLongLong(ge.count);
            } else if (rcodes[(size_t)r] == 1) {
                if (!p.seen) {
                    payload = Py_BuildValue("(OL)", Py_None, (long long)0);
                } else {
                    Py_ssize_t ix = ridx[(size_t)r][0];
                    PyObject* tot =
                        f->cols[(size_t)ix].tag == CF_F64
                            ? PyFloat_FromDouble(p.dsum)
                            : PyLong_FromLongLong(p.isum);
                    if (tot != nullptr) {
                        payload = Py_BuildValue("(NL)", tot, p.cnt);
                        if (payload == nullptr) Py_DECREF(tot);
                    }
                }
            } else {
                payload = PyDict_New();
                if (payload != nullptr) {
                    for (MsItem& it : p.msitems) {
                        PyObject* dv = Py_BuildValue("(LO)", it.delta,
                                                     it.args);
                        if (dv == nullptr ||
                            PyDict_SetItem(payload, it.h, dv) < 0) {
                            Py_XDECREF(dv);
                            Py_DECREF(payload);
                            payload = nullptr;
                            break;
                        }
                        Py_DECREF(dv);
                    }
                }
            }
            if (payload == nullptr) {
                Py_DECREF(parts);
                Py_DECREF(gv);
                fail = true;
                break;
            }
            PyTuple_SET_ITEM(parts, r, payload);
        }
        if (fail) break;
        PyObject* val = Py_BuildValue("(LO)", ge.count, parts);
        Py_DECREF(parts);
        if (val == nullptr || PyDict_SetItem(out, gv, val) < 0) {
            Py_XDECREF(val);
            Py_DECREF(gv);
            fail = true;
            break;
        }
        Py_DECREF(val);
        Py_DECREF(gv);
    }
    free_entries();
    if (fail) {
        Py_DECREF(out);
        return nullptr;
    }
    return out;
}

// ---- frame routing / projection / filtering --------------------------

template <typename Sink>
bool frame_feed_cell(Sink& sink, const Frame* f, Py_ssize_t ix, size_t i) {
    if (ix < 0) {
        uint8_t kb[16];
        f->key_digest(i, kb);
        sink.tag(0x07);
        sink.bytes(kb, 16);
        return true;
    }
    const FrameCol& c = f->cols[(size_t)ix];
    if (!c.is_valid(i)) {
        sink.tag(0x00);
        return true;
    }
    switch (c.tag) {
        case CF_I64:
            feed_small_int(sink, c.i64[i]);
            return true;
        case CF_F64: {
            double d = c.f64[i];
            sink.tag(0x03);
            sink.bytes(&d, 8);
            return true;
        }
        case CF_STR: {
            Py_ssize_t n;
            const char* s = PyUnicode_AsUTF8AndSize(f->pool[c.sidx[i]], &n);
            if (s == nullptr) return false;
            sink.tag(0x04);
            sink.u64le((uint64_t)n);
            sink.bytes(s, (size_t)n);
            return true;
        }
        case CF_BOOL:
            sink.tag(0x01);
            sink.tag(c.b8[i] ? 0x01 : 0x00);
            return true;
        default:
            return false;
    }
}

PyObject* py_frame_route_split(PyObject*, PyObject* args) {
    // frame_route_split(frame, idx_tuple, W) -> list of W frames.
    // Destinations are byte-identical to route_split on the materialized
    // rows: positional cells feed the same tagged stream into the same
    // digest memo; the empty tuple means int(key) % W.  Single
    // string-column routes memoize the destination per POOL INDEX, so a
    // million-row frame over a 1k vocabulary does ~1k digests.
    PyObject *cap, *idxs;
    long W;
    if (!PyArg_ParseTuple(args, "OOl", &cap, &idxs, &W)) return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    if (W <= 0 || !PyTuple_Check(idxs)) {
        PyErr_SetString(PyExc_ValueError, "bad frame_route_split arguments");
        return nullptr;
    }
    Py_ssize_t nidx = PyTuple_GET_SIZE(idxs);
    std::vector<Py_ssize_t> pos((size_t)nidx);
    for (Py_ssize_t i = 0; i < nidx; i++) {
        pos[(size_t)i] = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, i));
        if (pos[(size_t)i] == -1 && PyErr_Occurred()) return nullptr;
        if (pos[(size_t)i] >= (Py_ssize_t)f->cols.size()) {
            PyErr_SetString(PyExc_IndexError, "route column out of range");
            return nullptr;
        }
    }
    if (nidx == 0) f->materialize_keys();  // key routing needs digests

    std::vector<std::unique_ptr<Frame>> outs;
    outs.reserve((size_t)W);
    for (long w = 0; w < W; w++) outs.emplace_back(f->like());

    bool single_str = nidx == 1 && pos[0] >= 0 &&
                      f->cols[(size_t)pos[0]].tag == CF_STR;
    std::vector<long> dest_by_pool;
    long dest_null = -1;
    if (single_str) dest_by_pool.assign(f->pool.size(), -1);
    std::string cells;

    for (int64_t i = 0; i < f->n_rows; i++) {
        long dest;
        if (nidx == 0) {
            // int(key) % W on the 128-bit LE digest
            uint64_t lo, hi;
            std::memcpy(&lo, f->keyb.data() + 16 * (size_t)i, 8);
            std::memcpy(&hi, f->keyb.data() + 16 * (size_t)i + 8, 8);
            unsigned __int128 v =
                ((unsigned __int128)hi << 64) | (unsigned __int128)lo;
            dest = (long)(unsigned long long)(v % (unsigned long long)W);
        } else {
            long* slot = nullptr;
            if (single_str) {
                const FrameCol& c = f->cols[(size_t)pos[0]];
                slot = c.is_valid((size_t)i)
                           ? &dest_by_pool[c.sidx[(size_t)i]]
                           : &dest_null;
                if (*slot >= 0) {
                    outs[(size_t)*slot]->append_row_from(*f, (size_t)i);
                    continue;
                }
            }
            cells.clear();
            ByteSink sink{cells};
            bool ok = true;
            for (Py_ssize_t j = 0; j < nidx && ok; j++)
                ok = frame_feed_cell(sink, f, pos[(size_t)j], (size_t)i);
            if (!ok) {
                if (!PyErr_Occurred())
                    PyErr_SetString(g_unsupported, "unroutable cell");
                return nullptr;
            }
            uint8_t dg[16];
            route_digest(cells, dg);
            uint64_t lo, hi;
            std::memcpy(&lo, dg, 8);
            std::memcpy(&hi, dg + 8, 8);
            unsigned __int128 v =
                ((unsigned __int128)hi << 64) | (unsigned __int128)lo;
            dest = (long)(unsigned long long)(v % (unsigned long long)W);
            if (slot != nullptr) *slot = dest;
        }
        outs[(size_t)dest]->append_row_from(*f, (size_t)i);
    }
    PyObject* out = PyList_New(W);
    if (out == nullptr) return nullptr;
    for (long w = 0; w < W; w++) {
        PyObject* c = frame_to_capsule(outs[(size_t)w].release());
        if (c == nullptr) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, w, c);
    }
    return out;
}

PyObject* py_frame_project(PyObject*, PyObject* args) {
    // frame_project(frame, pos_tuple) -> frame with the selected value
    // columns (keys/diffs/pool preserved) — the columnar form of a
    // pure-projection rowwise node
    PyObject *cap, *idxs;
    if (!PyArg_ParseTuple(args, "OO!", &cap, &PyTuple_Type, &idxs))
        return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    std::unique_ptr<Frame> out(new Frame());
    out->n_rows = f->n_rows;
    out->pool = f->pool;
    for (PyObject* s : out->pool) Py_INCREF(s);
    out->keys_lazy = f->keys_lazy;
    out->key_base = f->key_base;
    out->key_offset = f->key_offset;
    out->key_seqs = f->key_seqs;
    out->keyb = f->keyb;
    out->all_plus = f->all_plus;
    out->diffs = f->diffs;
    Py_ssize_t nsel = PyTuple_GET_SIZE(idxs);
    out->cols.resize((size_t)nsel);
    for (Py_ssize_t j = 0; j < nsel; j++) {
        Py_ssize_t ix = PyLong_AsSsize_t(PyTuple_GET_ITEM(idxs, j));
        if (ix == -1 && PyErr_Occurred()) return nullptr;
        if (ix < 0 || ix >= (Py_ssize_t)f->cols.size()) {
            PyErr_SetString(PyExc_IndexError, "project column out of range");
            return nullptr;
        }
        out->cols[(size_t)j] = f->cols[(size_t)ix];  // column copy
    }
    return frame_to_capsule(out.release());
}

enum FrameCmp {
    FC_EQ = 0,
    FC_NE = 1,
    FC_LT = 2,
    FC_LE = 3,
    FC_GT = 4,
    FC_GE = 5,
};

template <typename T>
inline bool frame_cmp(int op, T a, T b) {
    switch (op) {
        case FC_EQ: return a == b;
        case FC_NE: return a != b;
        case FC_LT: return a < b;
        case FC_LE: return a <= b;
        case FC_GT: return a > b;
        default: return a >= b;
    }
}

PyObject* py_frame_filter(PyObject*, PyObject* args) {
    // frame_filter(frame, pos, op, const) -> frame keeping rows where
    // column[pos] <op> const.  None cells follow Python comparison
    // semantics under FilterNode's drop rules: == is False (drop),
    // != is True (keep), ordering raises (drop).  Type pairings are
    // strict — any cross-type compare falls back to the row path so
    // exact-arithmetic parity (int64 vs float) is never at risk.
    PyObject *cap, *cobj;
    long long posl;
    int op;
    if (!PyArg_ParseTuple(args, "OLiO", &cap, &posl, &op, &cobj))
        return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    if (posl < 0 || posl >= (long long)f->cols.size() || op < 0 || op > 5) {
        PyErr_SetString(PyExc_ValueError, "bad frame_filter arguments");
        return nullptr;
    }
    const FrameCol& c = f->cols[(size_t)posl];
    long long ci = 0;
    double cd = 0.0;
    std::string cs;
    if (c.tag == CF_I64 && PyLong_CheckExact(cobj)) {
        int overflow = 0;
        ci = PyLong_AsLongLongAndOverflow(cobj, &overflow);
        if (overflow != 0 || (ci == -1 && PyErr_Occurred())) {
            PyErr_Clear();
            PyErr_SetString(g_unsupported, "filter constant out of range");
            return nullptr;
        }
    } else if (c.tag == CF_F64 && PyFloat_CheckExact(cobj)) {
        cd = PyFloat_AS_DOUBLE(cobj);
    } else if (c.tag == CF_BOOL && PyBool_Check(cobj)) {
        ci = cobj == Py_True ? 1 : 0;
    } else if (c.tag == CF_STR && PyUnicode_CheckExact(cobj)) {
        Py_ssize_t n;
        const char* s = PyUnicode_AsUTF8AndSize(cobj, &n);
        if (s == nullptr) return nullptr;
        cs.assign(s, (size_t)n);
    } else {
        PyErr_SetString(g_unsupported, "filter type pairing not columnar");
        return nullptr;
    }
    std::unique_ptr<Frame> out(f->like());
    for (int64_t i = 0; i < f->n_rows; i++) {
        bool keep;
        if (!c.is_valid((size_t)i)) {
            keep = op == FC_NE;  // None != const is True; rest drop
        } else {
            switch (c.tag) {
                case CF_I64:
                    keep = frame_cmp(op, (long long)c.i64[(size_t)i], ci);
                    break;
                case CF_F64: keep = frame_cmp(op, c.f64[(size_t)i], cd); break;
                case CF_BOOL:
                    keep = frame_cmp(op, (long long)c.b8[(size_t)i], ci);
                    break;
                default: {
                    // UTF-8 byte order == code point order
                    Py_ssize_t n;
                    const char* s = PyUnicode_AsUTF8AndSize(
                        f->pool[c.sidx[(size_t)i]], &n);
                    if (s == nullptr) return nullptr;
                    int r = std::memcmp(
                        s, cs.data(),
                        std::min((size_t)n, cs.size()));
                    if (r == 0)
                        r = (size_t)n < cs.size() ? -1
                            : (size_t)n > cs.size() ? 1 : 0;
                    keep = frame_cmp(op, (long long)r, (long long)0);
                    break;
                }
            }
        }
        if (keep) out->append_row_from(*f, (size_t)i);
    }
    return frame_to_capsule(out.release());
}

// ---- frame wire codec -------------------------------------------------
//
// One blob per (peer, slot): fixed-width column buffers memcpy'd in and
// out, string pool shared across every frame of ONE transmission
// (tx/rx pool capsules), lazy keys shipped as (hash state, seqs) so the
// receiver inherits the 8-bytes-per-key representation.  Decode is
// bounds-checked everywhere — a truncated or corrupt frame raises
// ValueError, never reads past the buffer.

constexpr uint8_t kFrameMagic = 0xCF;
constexpr uint8_t kFrameVersion = 1;
constexpr size_t kFramePoolShareCap = 1 << 20;  // tx/rx symmetric cap

struct FrameTxPool {
    std::unordered_map<std::string, uint32_t> map;
    unsigned long long hits = 0;
    unsigned long long misses = 0;
};
const char kTxPoolCap[] = "pathway_tpu.frame_txpool";
void txpool_free(PyObject* cap) {
    delete static_cast<FrameTxPool*>(
        PyCapsule_GetPointer(cap, kTxPoolCap));
}

struct FrameRxPool {
    std::vector<PyObject*> strs;  // owned
    ~FrameRxPool() {
        for (PyObject* s : strs) Py_XDECREF(s);
    }
};
const char kRxPoolCap[] = "pathway_tpu.frame_rxpool";
void rxpool_free(PyObject* cap) {
    delete static_cast<FrameRxPool*>(
        PyCapsule_GetPointer(cap, kRxPoolCap));
}

PyObject* py_frame_txpool_new(PyObject*, PyObject*) {
    return PyCapsule_New(new FrameTxPool(), kTxPoolCap, txpool_free);
}

PyObject* py_frame_rxpool_new(PyObject*, PyObject*) {
    return PyCapsule_New(new FrameRxPool(), kRxPoolCap, rxpool_free);
}

PyObject* py_frame_txpool_stats(PyObject*, PyObject* cap) {
    FrameTxPool* tp =
        static_cast<FrameTxPool*>(PyCapsule_GetPointer(cap, kTxPoolCap));
    if (tp == nullptr) return nullptr;
    return Py_BuildValue("(KK)", tp->hits, tp->misses);
}

bool frame_pack_to(std::string& buf, Frame* f, FrameTxPool* tp) {
    buf.push_back((char)kFrameMagic);
    buf.push_back((char)kFrameVersion);
    uint8_t flags = (f->all_plus ? 1 : 0) | (f->keys_lazy ? 2 : 0);
    buf.push_back((char)flags);
    wf_put_u32(buf, (uint32_t)f->n_rows);
    uint16_t nc = (uint16_t)f->cols.size();
    buf.append((const char*)&nc, 2);
    wf_put_u32(buf, (uint32_t)f->pool.size());
    if (f->keys_lazy) {
        uint16_t ns = (uint16_t)sizeof(pwnative::Blake2bState);
        buf.append((const char*)&ns, 2);
        buf.append((const char*)&f->key_base, sizeof(pwnative::Blake2bState));
        wf_put_u64(buf, (uint64_t)f->key_offset);
        buf.append((const char*)f->key_seqs.data(), f->key_seqs.size() * 8);
    } else {
        buf.append((const char*)f->keyb.data(), f->keyb.size());
    }
    if (!f->all_plus)
        buf.append((const char*)f->diffs.data(), f->diffs.size());
    for (PyObject* s : f->pool) {
        Py_ssize_t n;
        const char* u8 = PyUnicode_AsUTF8AndSize(s, &n);
        if (u8 == nullptr) return false;
        if (tp != nullptr) {
            auto it = tp->map.find(std::string(u8, (size_t)n));
            if (it != tp->map.end()) {
                tp->hits++;
                buf.push_back((char)1);
                wf_put_u32(buf, it->second);
                continue;
            }
            tp->misses++;
            if (tp->map.size() < kFramePoolShareCap)
                tp->map.emplace(std::string(u8, (size_t)n),
                                (uint32_t)tp->map.size());
        }
        buf.push_back((char)0);
        wf_put_u32(buf, (uint32_t)n);
        buf.append(u8, (size_t)n);
    }
    for (const FrameCol& c : f->cols) {
        buf.push_back((char)c.tag);
        buf.push_back((char)(c.valid.empty() ? 0 : 1));
        switch (c.tag) {
            case CF_I64:
                buf.append((const char*)c.i64.data(), c.i64.size() * 8);
                break;
            case CF_F64:
                buf.append((const char*)c.f64.data(), c.f64.size() * 8);
                break;
            case CF_STR:
                buf.append((const char*)c.sidx.data(), c.sidx.size() * 4);
                break;
            case CF_BOOL:
                buf.append((const char*)c.b8.data(), c.b8.size());
                break;
            default:
                PyErr_SetString(PyExc_ValueError, "bad column tag");
                return false;
        }
        if (!c.valid.empty())
            buf.append((const char*)c.valid.data(), c.valid.size());
    }
    return true;
}

FrameTxPool* txpool_arg_opt(PyObject* obj) {
    if (obj == Py_None) return nullptr;
    return static_cast<FrameTxPool*>(PyCapsule_GetPointer(obj, kTxPoolCap));
}

PyObject* py_frame_pack(PyObject*, PyObject* args) {
    PyObject* cap;
    PyObject* tpobj = Py_None;
    if (!PyArg_ParseTuple(args, "O|O", &cap, &tpobj)) return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    FrameTxPool* tp = txpool_arg_opt(tpobj);
    if (tp == nullptr && tpobj != Py_None) return nullptr;
    std::string buf;
    buf.reserve(f->nbytes() + 64);
    if (!frame_pack_to(buf, f, tp)) return nullptr;
    return PyBytes_FromStringAndSize(buf.data(), (Py_ssize_t)buf.size());
}

PyObject* py_frame_pack_into(PyObject*, PyObject* args) {
    PyObject *cap, *target;
    PyObject* tpobj = Py_None;
    if (!PyArg_ParseTuple(args, "OO!|O", &cap, &PyByteArray_Type, &target,
                          &tpobj))
        return nullptr;
    Frame* f = frame_arg(cap);
    if (f == nullptr) return nullptr;
    FrameTxPool* tp = txpool_arg_opt(tpobj);
    if (tp == nullptr && tpobj != Py_None) return nullptr;
    static thread_local std::string buf;
    buf.clear();
    if (!frame_pack_to(buf, f, tp)) return nullptr;
    Py_ssize_t at = PyByteArray_GET_SIZE(target);
    if (PyByteArray_Resize(target, at + (Py_ssize_t)buf.size()) < 0)
        return nullptr;
    std::memcpy(PyByteArray_AS_STRING(target) + at, buf.data(), buf.size());
    return PyLong_FromSsize_t((Py_ssize_t)buf.size());
}

PyObject* py_frame_unpack(PyObject*, PyObject* args) {
    PyObject* src;
    PyObject* rpobj = Py_None;
    if (!PyArg_ParseTuple(args, "O|O", &src, &rpobj)) return nullptr;
    FrameRxPool* rp = nullptr;
    if (rpobj != Py_None) {
        rp = static_cast<FrameRxPool*>(
            PyCapsule_GetPointer(rpobj, kRxPoolCap));
        if (rp == nullptr) return nullptr;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(src, &view, PyBUF_SIMPLE) < 0) return nullptr;
    const uint8_t* p = static_cast<const uint8_t*>(view.buf);
    const uint8_t* end = p + view.len;
    std::unique_ptr<Frame> f(new Frame());

    auto truncated = [&view]() -> PyObject* {
        PyBuffer_Release(&view);
        if (!PyErr_Occurred())
            PyErr_SetString(PyExc_ValueError, "truncated columnar frame");
        return nullptr;
    };
    auto need = [&p, end](size_t n) { return (size_t)(end - p) >= n; };

    if (!need(13)) return truncated();
    if (p[0] != kFrameMagic || p[1] != kFrameVersion) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bad columnar frame header");
        return nullptr;
    }
    uint8_t flags = p[2];
    uint32_t n_rows;
    uint16_t n_cols;
    uint32_t n_pool;
    std::memcpy(&n_rows, p + 3, 4);
    std::memcpy(&n_cols, p + 7, 2);
    std::memcpy(&n_pool, p + 9, 4);
    p += 13;
    if (n_rows > (uint32_t)INT32_MAX) return truncated();
    f->n_rows = (int64_t)n_rows;
    f->all_plus = (flags & 1) != 0;
    f->keys_lazy = (flags & 2) != 0;
    if (f->keys_lazy) {
        if (!need(2)) return truncated();
        uint16_t ns;
        std::memcpy(&ns, p, 2);
        p += 2;
        if (ns != sizeof(pwnative::Blake2bState)) {
            PyBuffer_Release(&view);
            PyErr_SetString(PyExc_ValueError,
                            "columnar frame hash-state size mismatch");
            return nullptr;
        }
        if (!need(sizeof(pwnative::Blake2bState) + 8 + (size_t)n_rows * 8))
            return truncated();
        std::memcpy(&f->key_base, p, sizeof(pwnative::Blake2bState));
        p += sizeof(pwnative::Blake2bState);
        uint64_t off;
        std::memcpy(&off, p, 8);
        p += 8;
        f->key_offset = (int64_t)off;
        f->key_seqs.resize(n_rows);
        std::memcpy(f->key_seqs.data(), p, (size_t)n_rows * 8);
        p += (size_t)n_rows * 8;
    } else {
        if (!need((size_t)n_rows * 16)) return truncated();
        f->keyb.assign(p, p + (size_t)n_rows * 16);
        p += (size_t)n_rows * 16;
    }
    if (!f->all_plus) {
        if (!need(n_rows)) return truncated();
        f->diffs.resize(n_rows);
        std::memcpy(f->diffs.data(), p, n_rows);
        p += n_rows;
    }
    f->pool.reserve(n_pool);
    for (uint32_t s = 0; s < n_pool; s++) {
        if (!need(1)) return truncated();
        uint8_t kind = *p++;
        if (kind == 0) {
            if (!need(4)) return truncated();
            uint32_t len;
            std::memcpy(&len, p, 4);
            p += 4;
            if (!need(len)) return truncated();
            PyObject* str = PyUnicode_DecodeUTF8(
                reinterpret_cast<const char*>(p), (Py_ssize_t)len, nullptr);
            if (str == nullptr) return truncated();
            p += len;
            // rx-pool mirror of the encoder's insert-on-first-sight
            if (rp != nullptr && rp->strs.size() < kFramePoolShareCap) {
                Py_INCREF(str);
                rp->strs.push_back(str);
            }
            f->pool.push_back(str);
        } else if (kind == 1) {
            if (!need(4)) return truncated();
            uint32_t ref;
            std::memcpy(&ref, p, 4);
            p += 4;
            if (rp == nullptr || ref >= rp->strs.size()) {
                PyBuffer_Release(&view);
                PyErr_SetString(PyExc_ValueError,
                                "bad string pool ref in columnar frame");
                return nullptr;
            }
            PyObject* str = rp->strs[ref];
            Py_INCREF(str);
            f->pool.push_back(str);
        } else {
            PyBuffer_Release(&view);
            PyErr_SetString(PyExc_ValueError,
                            "bad pool entry kind in columnar frame");
            return nullptr;
        }
    }
    f->cols.resize(n_cols);
    for (uint16_t c = 0; c < n_cols; c++) {
        if (!need(2)) return truncated();
        uint8_t tag = p[0];
        uint8_t has_valid = p[1];
        p += 2;
        FrameCol& col = f->cols[c];
        col.tag = tag;
        switch (tag) {
            case CF_I64:
                if (!need((size_t)n_rows * 8)) return truncated();
                col.i64.resize(n_rows);
                std::memcpy(col.i64.data(), p, (size_t)n_rows * 8);
                p += (size_t)n_rows * 8;
                break;
            case CF_F64:
                if (!need((size_t)n_rows * 8)) return truncated();
                col.f64.resize(n_rows);
                std::memcpy(col.f64.data(), p, (size_t)n_rows * 8);
                p += (size_t)n_rows * 8;
                break;
            case CF_STR:
                if (!need((size_t)n_rows * 4)) return truncated();
                col.sidx.resize(n_rows);
                std::memcpy(col.sidx.data(), p, (size_t)n_rows * 4);
                p += (size_t)n_rows * 4;
                for (uint32_t v : col.sidx) {
                    if (v >= f->pool.size()) {
                        PyBuffer_Release(&view);
                        PyErr_SetString(
                            PyExc_ValueError,
                            "string index out of range in columnar frame");
                        return nullptr;
                    }
                }
                break;
            case CF_BOOL:
                if (!need(n_rows)) return truncated();
                col.b8.resize(n_rows);
                for (uint32_t i = 0; i < n_rows; i++)
                    col.b8[i] = p[i] ? 1 : 0;
                p += n_rows;
                break;
            default:
                PyBuffer_Release(&view);
                PyErr_SetString(PyExc_ValueError,
                                "bad column tag in columnar frame");
                return nullptr;
        }
        if (has_valid) {
            if (!need(n_rows)) return truncated();
            col.valid.resize(n_rows);
            for (uint32_t i = 0; i < n_rows; i++)
                col.valid[i] = p[i] ? 1 : 0;
            p += n_rows;
        }
    }
    if (p != end) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError,
                        "trailing bytes after columnar frame");
        return nullptr;
    }
    PyBuffer_Release(&view);
    return frame_to_capsule(f.release());
}

PyMethodDef kMethods[] = {
    {"frame_from_updates", py_frame_from_updates, METH_O,
     "columnarize an update batch into a frame capsule"},
    {"frame_to_updates", py_frame_to_updates, METH_O,
     "materialize a frame capsule back into a list of Updates"},
    {"frame_len", py_frame_len, METH_O, "row count of a frame"},
    {"frame_nbytes", py_frame_nbytes, METH_O,
     "approximate in-memory size of a frame"},
    {"frame_ncols", py_frame_ncols, METH_O, "value column count of a frame"},
    {"frame_all_plus", py_frame_all_plus, METH_O,
     "True iff every row diff in the frame is +1"},
    {"frame_slice", py_frame_slice, METH_VARARGS,
     "row-range copy of a frame (shared string pool)"},
    {"frame_parse_jsonl", py_frame_parse_jsonl, METH_VARARGS,
     "parse a block of JSONL lines directly into a frame (None = fallback)"},
    {"frame_groupby_partials", py_frame_groupby_partials, METH_VARARGS,
     "per-group partial aggregates of a frame (same output as "
     "groupby_partials)"},
    {"frame_route_split", py_frame_route_split, METH_VARARGS,
     "split a frame into W per-destination frames (route_split parity)"},
    {"frame_project", py_frame_project, METH_VARARGS,
     "select value columns of a frame by position"},
    {"frame_filter", py_frame_filter, METH_VARARGS,
     "keep frame rows where column <op> constant"},
    {"frame_pack", py_frame_pack, METH_VARARGS,
     "serialize a frame to wire bytes (optional tx string pool)"},
    {"frame_pack_into", py_frame_pack_into, METH_VARARGS,
     "append a frame's wire bytes to a bytearray, returning the length"},
    {"frame_unpack", py_frame_unpack, METH_VARARGS,
     "decode wire bytes into a frame (optional rx string pool)"},
    {"frame_txpool_new", py_frame_txpool_new, METH_NOARGS,
     "new per-transmission string pool for frame_pack"},
    {"frame_txpool_stats", py_frame_txpool_stats, METH_O,
     "(hits, misses) of a tx string pool"},
    {"frame_rxpool_new", py_frame_rxpool_new, METH_NOARGS,
     "new per-transmission string pool for frame_unpack"},
    {"ref_scalar", py_ref_scalar, METH_VARARGS,
     "128-bit key hash of the argument values"},
    {"hash_rows", py_hash_rows, METH_O,
     "batch 128-bit key hashes for a sequence of value tuples"},
    {"hash_prefix_ints", py_hash_prefix_ints, METH_VARARGS,
     "bulk Pointer keys for (prefix..., seq+offset) rows"},
    {"scan_lines", py_scan_lines, METH_O,
     "offsets of non-empty lines in a bytes buffer"},
    {"consolidate", py_consolidate, METH_VARARGS,
     "merge updates with equal (key, row), dropping zero-diff entries"},
    {"per_key_changes", py_per_key_changes, METH_O,
     "group a batch into per-key (removals, additions) lists"},
    {"build_adds", py_build_adds, METH_VARARGS,
     "bulk Update(key, values, +1) construction"},
    {"coerce_rows", py_coerce_rows, METH_VARARGS,
     "bulk schema coercion of row dicts into value tuples"},
    {"groupby_partials", py_groupby_partials, METH_VARARGS,
     "per-group partial aggregates of an update batch"},
    {"all_positive", py_all_positive, METH_O,
     "True iff every update diff is > 0"},
    {"all_dicts", py_all_dicts, METH_O,
     "True iff every element is a dict"},
    {"rowwise_map", py_rowwise_map, METH_VARARGS,
     "apply a row function across a batch, containing row errors"},
    {"route_split", py_route_split, METH_VARARGS,
     "split an update batch into per-worker outboxes by route-cell hash"},
    {"wp_build", py_wp_build, METH_VARARGS,
     "build a WordPiece vocab handle from a token->id dict"},
    {"wp_encode", py_wp_encode, METH_VARARGS,
     "BERT-tokenize a batch of ASCII texts (None marks python fallback)"},
    {"filter_batch", py_filter_batch, METH_VARARGS,
     "keep updates whose (key, values) satisfy the predicate"},
    {"rows_with_error", py_rows_with_error, METH_VARARGS,
     "select updates whose values contain the sentinel (identity compare)"},
    {"set_pointer_type", py_set_pointer_type, METH_O,
     "register the Pointer class for type-tagged hashing"},
    {"set_json_type", py_set_json_type, METH_O,
     "register the Json class for VM convert/get semantics"},
    {"set_update_type", py_set_update_type, METH_O,
     "register the Update class for binary exchange frames"},
    {"pack_updates", py_pack_updates, METH_O,
     "serialize an update batch to a tagged binary frame"},
    {"pack_updates_into", py_pack_updates_into, METH_VARARGS,
     "append an update frame to a bytearray; returns appended byte count"},
    {"capture_batch", py_capture_batch, METH_VARARGS,
     "apply an update batch to capture state (stream list + rows dict)"},
    {"pack_kv", py_pack_kv, METH_O,
     "serialize (key, values) pairs to a tagged binary frame"},
    {"unpack_kv", py_unpack_kv, METH_O,
     "parse a tagged binary kv frame back into (Pointer, values) pairs"},
    {"unpack_updates", py_unpack_updates, METH_O,
     "parse a tagged binary frame back into Update objects"},
    {"vm_compile", py_vm_compile, METH_VARARGS,
     "compile an expression bytecode program to a capsule"},
    {"vm_eval_batch", py_vm_eval_batch, METH_VARARGS,
     "evaluate per-column VM programs across an update batch"},
    {"vm_filter_batch", py_vm_filter_batch, METH_VARARGS,
     "keep updates whose VM predicate result is truthy"},
    {"join_process", py_join_process, METH_VARARGS,
     "full incremental equi-join epoch pass over dict arrangements"},
    {"hnsw_new", py_hnsw_new, METH_VARARGS,
     "create an HNSW graph ANN index (dim, M, ef_construction, metric)"},
    {"hnsw_add", py_hnsw_add, METH_VARARGS,
     "bulk-insert float32 rows; returns assigned slots"},
    {"hnsw_remove", py_hnsw_remove, METH_VARARGS,
     "tombstone slots (freed for reuse)"},
    {"hnsw_search", py_hnsw_search, METH_VARARGS,
     "batch ANN search: (slots, distances) per query"},
    {"hnsw_len", py_hnsw_len, METH_O, "live item count"},
    {"monotonic_ns", py_monotonic_ns, METH_NOARGS,
     "steady-clock nanoseconds (latency probe timestamps)"},
    {"hist_new", py_hist_new, METH_NOARGS,
     "new log-bucketed concurrent latency histogram"},
    {"hist_record", py_hist_record, METH_VARARGS,
     "record a nanosecond sample into a histogram"},
    {"hist_snapshot", py_hist_snapshot, METH_VARARGS,
     "count/sum/max and p50/p95/p99 of a histogram"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "pathway_torch_native",
                       "pathway_tpu_torch C++ host hot paths", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_pathway_torch_native(void) {
    PyDateTime_IMPORT;  // .dt namespace methods use the C datetime API
    if (PyDateTimeAPI == nullptr) return nullptr;
    PyObject* m = PyModule_Create(&kModule);
    if (m == nullptr) return nullptr;
    g_unsupported =
        PyErr_NewException("pathway_torch_native.Unsupported", nullptr, nullptr);
    Py_INCREF(g_unsupported);
    PyModule_AddObject(m, "Unsupported", g_unsupported);
    return m;
}
