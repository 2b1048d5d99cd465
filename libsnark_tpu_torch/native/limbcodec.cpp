/* Host codec of the port: big integers <-> packed 16-bit limbs in uint32.
 *
 * The layout is ops/limbs.py's: an (n, m) uint32 array, limb axis leading,
 * limb i of element j at i * m + j, little-endian limbs. Each integer's
 * bytes come from (and go to) CPython's own byte-array conversion of its
 * int, where the Python form builds a bytes object per element.
 *
 * Module _limbcodec:
 *   encode(xs: sequence of ints, n[, p]) -> bytearray  # (n, len(xs)) u32;
 *       with a modulus p, each int that is negative or at least p is
 *       first reduced to x % p (Python's %, so the result lies in
 *       [0, p)); the others are packed as they are. OverflowError for a
 *       negative int or one of 2^(16 n) or more (after the reduction)
 *   decode(buf: bytes-like, n, m) -> list[int] # the low 16 bits of each
 *       of the n * m uint32 limbs
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstring>
#include <vector>

/* x < 2^63 packed straight from its machine word: the common case of
 * witnesses that are mostly bits and small words. */
static inline void put_small(uint32_t *dst, Py_ssize_t n, Py_ssize_t m,
                             Py_ssize_t j, unsigned long long v) {
    for (Py_ssize_t i = 0; i < n && v; ++i, v >>= 16)
        dst[(size_t)i * m + j] = (uint32_t)(v & 0xFFFF);
}

static PyObject *encode(PyObject *, PyObject *args) {
    PyObject *xs;
    Py_ssize_t n;
    PyObject *p = Py_None;
    if (!PyArg_ParseTuple(args, "On|O", &xs, &n, &p)) return nullptr;
    PyObject *mod = nullptr;       /* the modulus as an int, or null */
    long long p_small = -1;        /* p where it fits a long long, else -1 */
    if (p != Py_None) {
        mod = PyNumber_Long(p);
        if (!mod) return nullptr;
        if (_PyLong_Sign(mod) <= 0) {
            Py_DECREF(mod);
            PyErr_SetString(PyExc_ValueError, "modulus must be positive");
            return nullptr;
        }
        int ovf = 0;
        long long v = PyLong_AsLongLongAndOverflow(mod, &ovf);
        if (!ovf) p_small = v;
    }
    PyObject *seq = PySequence_Fast(xs, "expected a sequence");
    if (!seq) { Py_XDECREF(mod); return nullptr; }
    Py_ssize_t m = PySequence_Fast_GET_SIZE(seq);

    PyObject *out =
        PyByteArray_FromStringAndSize(nullptr, (Py_ssize_t)(n * m * 4));
    if (!out) { Py_DECREF(seq); Py_XDECREF(mod); return nullptr; }
    uint32_t *dst = (uint32_t *)PyByteArray_AS_STRING(out);
    std::memset(dst, 0, (size_t)(n * m * 4));
    const int small_bits = n >= 4 ? 64 : (int)(16 * n);

    std::vector<unsigned char> tmp((size_t)(2 * n));
    for (Py_ssize_t j = 0; j < m; ++j) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, j);
        PyObject *val = PyNumber_Long(item);
        if (!val) goto fail;
        {
            int ovf = 0;
            long long v = PyLong_AsLongLongAndOverflow(val, &ovf);
            if (!ovf && v >= 0 && (p_small < 0 || v < p_small)
                    && (small_bits == 64 || (v >> small_bits) == 0)) {
                Py_DECREF(val);
                put_small(dst, n, m, j, (unsigned long long)v);
                continue;
            }
        }
        if (mod) {
            int neg = _PyLong_Sign(val) < 0;
            int big = neg ? 0 : PyObject_RichCompareBool(val, mod, Py_GE);
            if (big < 0) { Py_DECREF(val); goto fail; }
            if (neg || big) {
                PyObject *red = PyNumber_Remainder(val, mod);
                Py_DECREF(val);
                if (!red) goto fail;
                val = red;
            }
        }
        std::memset(tmp.data(), 0, tmp.size());
        /* little-endian, unsigned */
#if PY_VERSION_HEX >= 0x030D0000
        if (_PyLong_AsByteArray((PyLongObject *)val, tmp.data(), tmp.size(),
                                1, 0, 1) < 0) {
#else
        if (_PyLong_AsByteArray((PyLongObject *)val, tmp.data(), tmp.size(),
                                1, 0) < 0) {
#endif
            Py_DECREF(val);
            goto fail;
        }
        Py_DECREF(val);
        for (Py_ssize_t i = 0; i < n; ++i) {
            dst[(size_t)i * m + j] =
                (uint32_t)tmp[2 * i] | ((uint32_t)tmp[2 * i + 1] << 8);
        }
    }
    Py_DECREF(seq);
    Py_XDECREF(mod);
    return out;
fail:
    Py_DECREF(seq);
    Py_DECREF(out);
    Py_XDECREF(mod);
    return nullptr;
}

static PyObject *decode(PyObject *, PyObject *args) {
    Py_buffer buf;
    Py_ssize_t n, m;
    if (!PyArg_ParseTuple(args, "y*nn", &buf, &n, &m)) return nullptr;
    if (buf.len < (Py_ssize_t)(n * m * 4)) {
        PyBuffer_Release(&buf);
        PyErr_SetString(PyExc_ValueError, "buffer too small");
        return nullptr;
    }
    const uint32_t *src = (const uint32_t *)buf.buf;
    PyObject *out = PyList_New(m);
    if (!out) { PyBuffer_Release(&buf); return nullptr; }
    std::vector<unsigned char> tmp((size_t)(2 * n));
    for (Py_ssize_t j = 0; j < m; ++j) {
        for (Py_ssize_t i = 0; i < n; ++i) {
            uint32_t v = src[(size_t)i * m + j];
            tmp[2 * i] = (unsigned char)(v & 0xFF);
            tmp[2 * i + 1] = (unsigned char)((v >> 8) & 0xFF);
        }
        PyObject *val = _PyLong_FromByteArray(tmp.data(), tmp.size(), 1, 0);
        if (!val) { PyBuffer_Release(&buf); Py_DECREF(out); return nullptr; }
        PyList_SET_ITEM(out, j, val);
    }
    PyBuffer_Release(&buf);
    return out;
}

static PyMethodDef methods[] = {
    {"encode", encode, METH_VARARGS,
     "encode(xs, n[, p]) -> limb-major uint32 bytearray (x % p where x < 0 "
     "or x >= p)"},
    {"decode", decode, METH_VARARGS,
     "decode(buf, n, m) -> list of ints"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_limbcodec",
    "big integer <-> packed 16-bit limb codec", -1, methods};

PyMODINIT_FUNC PyInit__limbcodec(void) {
    return PyModule_Create(&moduledef);
}
