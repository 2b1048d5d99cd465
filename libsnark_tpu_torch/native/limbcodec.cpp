/* Host codec of the port: big integers <-> packed 16-bit limbs in uint32.
 *
 * The layout is ops/limbs.py's: an (n, m) uint32 array, limb axis leading,
 * limb i of element j at i * m + j, little-endian limbs. Each integer's
 * bytes come from (and go to) CPython's own byte-array conversion of its
 * int, where the Python form builds a bytes object per element.
 *
 * Module _limbcodec:
 *   encode(xs: sequence of ints, n) -> bytes   # (n, len(xs)) uint32;
 *       OverflowError for a negative int or one of 2^(16 n) or more
 *   decode(buf: bytes-like, n, m) -> list[int] # the low 16 bits of each
 *       of the n * m uint32 limbs
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <cstring>
#include <vector>

static PyObject *encode(PyObject *, PyObject *args) {
    PyObject *xs;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "On", &xs, &n)) return nullptr;
    PyObject *seq = PySequence_Fast(xs, "expected a sequence");
    if (!seq) return nullptr;
    Py_ssize_t m = PySequence_Fast_GET_SIZE(seq);

    PyObject *out = PyBytes_FromStringAndSize(nullptr, (Py_ssize_t)(n * m * 4));
    if (!out) { Py_DECREF(seq); return nullptr; }
    uint32_t *dst = (uint32_t *)PyBytes_AS_STRING(out);
    std::memset(dst, 0, (size_t)(n * m * 4));

    std::vector<unsigned char> tmp((size_t)(2 * n));
    for (Py_ssize_t j = 0; j < m; ++j) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, j);
        PyObject *val = PyNumber_Long(item);
        if (!val) { Py_DECREF(seq); Py_DECREF(out); return nullptr; }
        std::memset(tmp.data(), 0, tmp.size());
        /* little-endian, unsigned */
#if PY_VERSION_HEX >= 0x030D0000
        if (_PyLong_AsByteArray((PyLongObject *)val, tmp.data(), tmp.size(),
                                1, 0, 1) < 0) {
#else
        if (_PyLong_AsByteArray((PyLongObject *)val, tmp.data(), tmp.size(),
                                1, 0) < 0) {
#endif
            Py_DECREF(val); Py_DECREF(seq); Py_DECREF(out);
            return nullptr;
        }
        Py_DECREF(val);
        for (Py_ssize_t i = 0; i < n; ++i) {
            dst[(size_t)i * m + j] =
                (uint32_t)tmp[2 * i] | ((uint32_t)tmp[2 * i + 1] << 8);
        }
    }
    Py_DECREF(seq);
    return out;
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
     "encode(xs, n) -> limb-major uint32 bytes"},
    {"decode", decode, METH_VARARGS,
     "decode(buf, n, m) -> list of ints"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_limbcodec",
    "big integer <-> packed 16-bit limb codec", -1, methods};

PyMODINIT_FUNC PyInit__limbcodec(void) {
    return PyModule_Create(&moduledef);
}
