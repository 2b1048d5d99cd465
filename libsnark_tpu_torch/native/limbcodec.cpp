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
 *   mark(lcs: sequence of term lists, seen: bytearray) -> None
 *       # seen[t.index] = 1 for every term t of every list (IndexError
 *       # for an index outside seen)
 *   compact(lcs: sequence of term lists, p, rows, cols, coeffs) -> None
 *       # relations/variable.py's compact_terms for each list j of
 *       objects with .index and .coeff: duplicate indices merged, the
 *       sums reduced mod p (Python's %), zeros dropped, in index order;
 *       appends j, each index and each coefficient to the three lists
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <algorithm>
#include <climits>
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

/* One term of a linear combination: its index, and its coefficient as a
 * machine word when it fits (small) or else the int object itself. */
struct Term {
    long long index;
    long long small;
    PyObject *big;      /* borrowed from owned (compact's list of the
                         * term list's big coefficients); nullptr when
                         * small */
};

/* Reads a term's index and coeff: straight from their __slots__ when
 * the term's type keeps them there (relations/variable.py's LinearTerm),
 * else through getattr. */
struct TermReader {
    PyTypeObject *type = nullptr;
    Py_ssize_t index_at = -1, coeff_at = -1;
    PyObject *s_index = PyUnicode_InternFromString("index");
    PyObject *s_coeff = PyUnicode_InternFromString("coeff");

    ~TermReader() {
        Py_XDECREF(s_index);
        Py_XDECREF(s_coeff);
    }

    static Py_ssize_t slot_offset(PyTypeObject *tp, PyObject *name) {
        PyObject *d = PyObject_GetAttr((PyObject *)tp, name);
        if (!d) {
            PyErr_Clear();
            return -1;
        }
        Py_ssize_t at = -1;
        if (Py_TYPE(d) == &PyMemberDescr_Type) {
            PyMemberDef *m = ((PyMemberDescrObject *)d)->d_member;
            if (m->type == T_OBJECT_EX) at = m->offset;
        }
        Py_DECREF(d);       /* the type's dict keeps the descriptor */
        return at;
    }

    /* New references to t.index and t.coeff; false with an exception. */
    bool read(PyObject *t, PyObject **index, PyObject **coeff) {
        if (Py_TYPE(t) != type) {
            type = Py_TYPE(t);
            index_at = slot_offset(type, s_index);
            coeff_at = slot_offset(type, s_coeff);
        }
        if (index_at >= 0 && coeff_at >= 0) {
            *index = *(PyObject **)((char *)t + index_at);
            *coeff = *(PyObject **)((char *)t + coeff_at);
            if (*index && *coeff) {
                Py_INCREF(*index);
                Py_INCREF(*coeff);
                return true;
            }
        }
        *index = PyObject_GetAttr(t, s_index);
        *coeff = *index ? PyObject_GetAttr(t, s_coeff) : nullptr;
        if (!*coeff) {
            Py_CLEAR(*index);
            return false;
        }
        return true;
    }
};

/* A new int of value v. */
static PyObject *from_i128(__int128 v) {
    if (v >= LLONG_MIN && v <= LLONG_MAX)
        return PyLong_FromLongLong((long long)v);
    PyObject *hi = PyLong_FromLongLong((long long)(v >> 64));
    PyObject *lo = PyLong_FromUnsignedLongLong((unsigned long long)v);
    PyObject *sh = PyLong_FromLong(64);
    PyObject *his = (hi && sh) ? PyNumber_Lshift(hi, sh) : nullptr;
    PyObject *out = (his && lo) ? PyNumber_Add(his, lo) : nullptr;
    Py_XDECREF(hi);
    Py_XDECREF(lo);
    Py_XDECREF(sh);
    Py_XDECREF(his);
    return out;
}

/* sum + v as a new int; consumes the reference to sum (which may be
 * nullptr: then a new reference to v). */
static PyObject *add_to(PyObject *sum, PyObject *v) {
    if (!sum) {
        Py_INCREF(v);
        return v;
    }
    PyObject *out = PyNumber_Add(sum, v);
    Py_DECREF(sum);
    return out;
}

/* The merged coefficient of one run of equal indices, mod p: a new int. */
static PyObject *run_sum(const Term *t, size_t n, PyObject *p, bool p_wide) {
    const __int128 LIMIT = (__int128)1 << 100;
    __int128 acc = 0;
    PyObject *sum = nullptr;
    for (size_t k = 0; k < n; ++k) {
        if (t[k].big) {
            sum = add_to(sum, t[k].big);
            if (!sum) return nullptr;
            continue;
        }
        acc += t[k].small;
        if (acc > LIMIT || acc < -LIMIT) {
            PyObject *v = from_i128(acc);
            if (!v) { Py_XDECREF(sum); return nullptr; }
            sum = add_to(sum, v);
            Py_DECREF(v);
            if (!sum) return nullptr;
            acc = 0;
        }
    }
    /* the common case: small coefficients summing below 2^63 <= p */
    if (!sum && p_wide && acc >= 0 && acc <= LLONG_MAX)
        return PyLong_FromLongLong((long long)acc);
    if (acc != 0 || !sum) {
        PyObject *v = from_i128(acc);
        if (!v) { Py_XDECREF(sum); return nullptr; }
        sum = add_to(sum, v);
        Py_DECREF(v);
        if (!sum) return nullptr;
    }
    PyObject *c = PyNumber_Remainder(sum, p);
    Py_DECREF(sum);
    return c;
}

static PyObject *compact(PyObject *, PyObject *args) {
    PyObject *lcs, *p, *rows, *cols, *coeffs;
    if (!PyArg_ParseTuple(args, "OO!O!O!O!", &lcs, &PyLong_Type, &p,
                          &PyList_Type, &rows, &PyList_Type, &cols,
                          &PyList_Type, &coeffs))
        return nullptr;
    int overflow = 0;
    long long p_word = PyLong_AsLongLongAndOverflow(p, &overflow);
    if (p_word == -1 && PyErr_Occurred()) return nullptr;
    if (overflow < 0 || (!overflow && p_word <= 0)) {
        PyErr_SetString(PyExc_ValueError, "compact: p must be positive");
        return nullptr;
    }
    const bool p_wide = overflow > 0;       /* p >= 2^63 */
    PyObject *seq = PySequence_Fast(lcs, "compact: lcs must be a sequence");
    if (!seq) return nullptr;
    TermReader reader;
    std::vector<Term> terms;
    bool bad = !reader.s_index || !reader.s_coeff;
    Py_ssize_t nl = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t j = 0; j < nl && !bad; ++j) {
        PyObject *tl = PySequence_Fast(PySequence_Fast_GET_ITEM(seq, j),
                                       "compact: a term list must be a "
                                       "sequence");
        if (!tl) { bad = true; break; }
        Py_ssize_t nt = PySequence_Fast_GET_SIZE(tl);
        terms.clear();
        terms.reserve(nt);
        /* a coefficient too wide for a word is held here until the list's
         * runs are summed: a term's coeff may be computed afresh on each
         * read, and then no one else keeps it */
        std::vector<PyObject *> owned;
        for (Py_ssize_t k = 0; k < nt && !bad; ++k) {
            PyObject *io, *co;
            Term term{0, 0, nullptr};
            if (reader.read(PySequence_Fast_GET_ITEM(tl, k), &io, &co)) {
                term.index = PyLong_AsLongLong(io);
                int ov = 0;
                term.small = PyLong_AsLongLongAndOverflow(co, &ov);
                if (ov) {
                    term.big = co;
                    owned.push_back(co);
                    co = nullptr;
                }
                bad = PyErr_Occurred() != nullptr;
            } else {
                bad = true;
            }
            Py_XDECREF(io);
            Py_XDECREF(co);
            terms.push_back(term);
        }
        std::stable_sort(terms.begin(), terms.end(),
                         [](const Term &a, const Term &b) {
                             return a.index < b.index;
                         });
        PyObject *row = bad ? nullptr : PyLong_FromSsize_t(j);
        bad = bad || !row;
        for (size_t a = 0, b; a < terms.size() && !bad; a = b) {
            for (b = a; b < terms.size() && terms[b].index == terms[a].index;)
                ++b;
            PyObject *c = run_sum(&terms[a], b - a, p, p_wide);
            int nz = c ? PyObject_IsTrue(c) : -1;
            if (nz > 0) {
                PyObject *idx = PyLong_FromLongLong(terms[a].index);
                bad = !idx || PyList_Append(rows, row) < 0 ||
                      PyList_Append(cols, idx) < 0 ||
                      PyList_Append(coeffs, c) < 0;
                Py_XDECREF(idx);
            } else {
                bad = nz < 0;
            }
            Py_XDECREF(c);
        }
        for (PyObject *o : owned) Py_DECREF(o);
        Py_XDECREF(row);
        Py_DECREF(tl);
    }
    Py_DECREF(seq);
    if (bad) return nullptr;
    Py_RETURN_NONE;
}

static PyObject *mark(PyObject *, PyObject *args) {
    PyObject *lcs, *seen;
    if (!PyArg_ParseTuple(args, "OY", &lcs, &seen)) return nullptr;
    char *flags = PyByteArray_AS_STRING(seen);
    Py_ssize_t size = PyByteArray_GET_SIZE(seen);
    PyObject *seq = PySequence_Fast(lcs, "mark: lcs must be a sequence");
    if (!seq) return nullptr;
    TermReader reader;
    bool bad = !reader.s_index || !reader.s_coeff;
    Py_ssize_t nl = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t j = 0; j < nl && !bad; ++j) {
        PyObject *tl = PySequence_Fast(PySequence_Fast_GET_ITEM(seq, j),
                                       "mark: a term list must be a "
                                       "sequence");
        if (!tl) { bad = true; break; }
        Py_ssize_t nt = PySequence_Fast_GET_SIZE(tl);
        for (Py_ssize_t k = 0; k < nt && !bad; ++k) {
            PyObject *io, *co;
            long long i = -1;
            if (reader.read(PySequence_Fast_GET_ITEM(tl, k), &io, &co)) {
                i = PyLong_AsLongLong(io);
                Py_DECREF(io);
                Py_DECREF(co);
            }
            if (PyErr_Occurred()) {
                bad = true;
            } else if (i < 0 || i >= size) {
                PyErr_SetString(PyExc_IndexError, "mark: index outside seen");
                bad = true;
            } else {
                flags[i] = 1;
            }
        }
        Py_DECREF(tl);
    }
    Py_DECREF(seq);
    if (bad) return nullptr;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"encode", encode, METH_VARARGS,
     "encode(xs, n[, p]) -> limb-major uint32 bytearray (x % p where x < 0 "
     "or x >= p)"},
    {"decode", decode, METH_VARARGS,
     "decode(buf, n, m) -> list of ints"},
    {"mark", mark, METH_VARARGS,
     "mark(lcs, seen) -> None: seen[t.index] = 1 for every term t"},
    {"compact", compact, METH_VARARGS,
     "compact(lcs, p, rows, cols, coeffs) -> None: each term list's "
     "duplicate indices merged, reduced mod p, zeros dropped, appended"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_limbcodec",
    "big integer <-> packed 16-bit limb codec", -1, methods};

PyMODINIT_FUNC PyInit__limbcodec(void) {
    return PyModule_Create(&moduledef);
}
