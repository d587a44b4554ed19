/* C implementation of the wire codec's value tree (rpc/wire.py).
 *
 * The reference's XDR layer is generated C (rpc/xdr/*); ours was a
 * recursive Python walk that profiled at ~30% of a served brick's CPU
 * under wire load.  This extension implements the SAME tagged format
 * byte-for-byte (tests cross-check every frame against the Python
 * codec) with the tree walk, varints and buffer appends in C.
 *
 * Python-defined classes (Iatt, Loc, FdHandle, FopError, Blob) are
 * registered by rpc/wire.py at first use; encoding reads their attributes
 * via the C API, decoding constructs them through registered factory
 * callables.  Unknown types raise WireError exactly like the Python
 * path.
 *
 * Built with gcc at first use by glusterfs_tpu_torch/native/__init__.py
 * (wirec_module); a failed build raises, and rpc/wire.py keeps its
 * Python codec only as the plain version the tests hold this one
 * against.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

enum {
    T_NONE = 0, T_TRUE = 1, T_FALSE = 2,
    T_INT = 3, T_NEGINT = 4, T_FLOAT = 5,
    T_BYTES = 6, T_STR = 7,
    T_LIST = 8, T_DICT = 9,
    T_IATT = 10, T_LOC = 11, T_FD = 12, T_ERR = 13,
    T_BLOBREF = 14,
};

/* registered from wire.py */
static PyObject *cls_iatt, *cls_loc, *cls_fd, *cls_err, *cls_blob;
static PyObject *mk_iatt, *mk_loc, *mk_fd, *mk_err;   /* factories */
static PyObject *wire_error;                          /* WireError */
static PyObject *blob_stats;                          /* dict */

/* -- growable output buffer -------------------------------------------- */

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} Out;

static int out_grow(Out *o, Py_ssize_t need)
{
    if (o->len + need <= o->cap)
        return 0;
    Py_ssize_t cap = o->cap ? o->cap : 256;
    while (cap < o->len + need)
        cap *= 2;
    char *nb = PyMem_Realloc(o->buf, cap);
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    o->buf = nb;
    o->cap = cap;
    return 0;
}

static inline int out_byte(Out *o, unsigned char b)
{
    if (out_grow(o, 1) < 0)
        return -1;
    o->buf[o->len++] = (char)b;
    return 0;
}

static inline int out_mem(Out *o, const void *p, Py_ssize_t n)
{
    if (out_grow(o, n) < 0)
        return -1;
    memcpy(o->buf + o->len, p, n);
    o->len += n;
    return 0;
}

static int out_uint(Out *o, unsigned long long n)
{
    do {
        unsigned char b = n & 0x7F;
        n >>= 7;
        if (out_byte(o, n ? (b | 0x80) : b) < 0)
            return -1;
    } while (n);
    return 0;
}

/* -- encode ------------------------------------------------------------ */

static int enc(PyObject *v, Out *o, PyObject *blobs);

static int enc_attr_list(PyObject *v, Out *o, const char *const *names,
                         int n, int tag)
{
    /* encode [getattr(v, name) for name in names] as a T_LIST */
    if (out_byte(o, (unsigned char)tag) < 0 || out_byte(o, T_LIST) < 0 ||
        out_uint(o, (unsigned long long)n) < 0)
        return -1;
    for (int i = 0; i < n; i++) {
        PyObject *a = PyObject_GetAttrString(v, names[i]);
        if (!a)
            return -1;
        int rc = enc(a, o, NULL);
        Py_DECREF(a);
        if (rc < 0)
            return -1;
    }
    return 0;
}

static int enc(PyObject *v, Out *o, PyObject *blobs)
{
    if (v == Py_None)
        return out_byte(o, T_NONE);
    if (v == Py_True)
        return out_byte(o, T_TRUE);
    if (v == Py_False)
        return out_byte(o, T_FALSE);

    if (PyLong_CheckExact(v)) {
        int overflow = 0;
        long long sv = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (!overflow) {
            if (sv >= 0) {
                if (out_byte(o, T_INT) < 0)
                    return -1;
                return out_uint(o, (unsigned long long)sv);
            }
            if (out_byte(o, T_NEGINT) < 0)
                return -1;
            return out_uint(o, (unsigned long long)(-sv));
        }
        /* > 63 bits: rare (tests use 2**40; xattr counters fit u64).
         * Positive ones still fit the unsigned path. */
        unsigned long long uv = PyLong_AsUnsignedLongLong(v);
        if (uv == (unsigned long long)-1 && PyErr_Occurred())
            return -1;
        if (out_byte(o, T_INT) < 0)
            return -1;
        return out_uint(o, uv);
    }
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        unsigned char be[8];
        /* big-endian IEEE double, like struct.pack(">d") */
        union { double d; unsigned long long u; } u;
        u.d = d;
        for (int i = 0; i < 8; i++)
            be[i] = (unsigned char)(u.u >> (56 - 8 * i));
        if (out_byte(o, T_FLOAT) < 0)
            return -1;
        return out_mem(o, be, 8);
    }
    if ((PyObject *)Py_TYPE(v) == cls_blob) {
        PyObject *view = PyObject_GetAttrString(v, "view");
        if (!view)
            return -1;
        Py_buffer pb;
        if (PyObject_GetBuffer(view, &pb, PyBUF_SIMPLE) < 0) {
            Py_DECREF(view);
            return -1;
        }
        int rc = -1;
        if (blobs && blobs != Py_None) {
            /* out-of-band lane: tiny ref in the body, view appended */
            if (out_byte(o, T_BLOBREF) == 0 &&
                out_uint(o, (unsigned long long)pb.len) == 0 &&
                PyList_Append(blobs, view) == 0)
                rc = 0;
        } else {
            if (out_byte(o, T_BYTES) == 0 &&
                out_uint(o, (unsigned long long)pb.len) == 0 &&
                out_mem(o, pb.buf, pb.len) == 0)
                rc = 0;
            if (rc == 0 && blob_stats) {
                PyObject *k = PyUnicode_FromString("inline_bytes");
                PyObject *cur = k ? PyDict_GetItem(blob_stats, k) : NULL;
                if (cur) {
                    PyObject *nv = PyNumber_Add(
                        cur, PyLong_FromSsize_t(pb.len));
                    if (nv) {
                        PyDict_SetItem(blob_stats, k, nv);
                        Py_DECREF(nv);
                    } else
                        PyErr_Clear();
                }
                Py_XDECREF(k);
            }
        }
        PyBuffer_Release(&pb);
        Py_DECREF(view);
        return rc;
    }
    if (PyBytes_CheckExact(v)) {
        if (out_byte(o, T_BYTES) < 0 ||
            out_uint(o, (unsigned long long)PyBytes_GET_SIZE(v)) < 0)
            return -1;
        return out_mem(o, PyBytes_AS_STRING(v), PyBytes_GET_SIZE(v));
    }
    if (PyByteArray_CheckExact(v) || PyMemoryView_Check(v)) {
        Py_buffer pb;
        if (PyObject_GetBuffer(v, &pb, PyBUF_SIMPLE) < 0)
            return -1;
        int rc = -1;
        if (out_byte(o, T_BYTES) == 0 &&
            out_uint(o, (unsigned long long)pb.len) == 0 &&
            out_mem(o, pb.buf, pb.len) == 0)
            rc = 0;
        PyBuffer_Release(&pb);
        return rc;
    }
    if (PyUnicode_CheckExact(v)) {
        /* surrogateescape round-trips raw filesystem names */
        PyObject *b = PyUnicode_AsEncodedString(v, "utf-8",
                                                "surrogateescape");
        if (!b)
            return -1;
        int rc = -1;
        if (out_byte(o, T_STR) == 0 &&
            out_uint(o, (unsigned long long)PyBytes_GET_SIZE(b)) == 0 &&
            out_mem(o, PyBytes_AS_STRING(b), PyBytes_GET_SIZE(b)) == 0)
            rc = 0;
        Py_DECREF(b);
        return rc;
    }
    if (PyList_CheckExact(v) || PyTuple_CheckExact(v)) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(v);
        if (out_byte(o, T_LIST) < 0 ||
            out_uint(o, (unsigned long long)n) < 0)
            return -1;
        PyObject **items = PySequence_Fast_ITEMS(v);
        for (Py_ssize_t i = 0; i < n; i++)
            if (enc(items[i], o, blobs) < 0)
                return -1;
        return 0;
    }
    if (PyDict_CheckExact(v)) {
        if (out_byte(o, T_DICT) < 0 ||
            out_uint(o, (unsigned long long)PyDict_GET_SIZE(v)) < 0)
            return -1;
        PyObject *k, *val;
        Py_ssize_t pos = 0;
        while (PyDict_Next(v, &pos, &k, &val)) {
            if (enc(k, o, blobs) < 0 || enc(val, o, blobs) < 0)
                return -1;
        }
        return 0;
    }
    {
        PyObject *t = (PyObject *)Py_TYPE(v);
        if (t == cls_iatt) {
            static const char *const names[] = {
                "gfid", "ia_type", "mode", "nlink", "uid", "gid",
                "size", "blocks", "atime", "mtime", "ctime", "rdev",
                "blksize"};
            /* ia_type is an IntEnum: encode its .value */
            PyObject *iat = PyObject_GetAttrString(v, "ia_type");
            if (!iat)
                return -1;
            PyObject *iav = PyObject_GetAttrString(iat, "value");
            Py_DECREF(iat);
            if (!iav)
                return -1;
            if (out_byte(o, T_IATT) < 0 || out_byte(o, T_LIST) < 0 ||
                out_uint(o, 13) < 0) {
                Py_DECREF(iav);
                return -1;
            }
            for (int i = 0; i < 13; i++) {
                PyObject *a;
                if (i == 1) {
                    a = iav;
                    Py_INCREF(a);
                } else {
                    a = PyObject_GetAttrString(v, names[i]);
                }
                if (!a) {
                    Py_DECREF(iav);
                    return -1;
                }
                int rc = enc(a, o, NULL);
                Py_DECREF(a);
                if (rc < 0) {
                    Py_DECREF(iav);
                    return -1;
                }
            }
            Py_DECREF(iav);
            return 0;
        }
        if (t == cls_loc) {
            static const char *const names[] = {"path", "gfid",
                                                "parent", "name"};
            return enc_attr_list(v, o, names, 4, T_LOC);
        }
        if (t == cls_fd) {
            static const char *const names[] = {"fdid", "gfid", "path"};
            return enc_attr_list(v, o, names, 3, T_FD);
        }
        if (PyObject_IsInstance(v, cls_err) == 1) {
            /* FopError: [err, message] where message = args[1] or "";
             * a non-empty .xdata dict (the error-path reply dict, e.g.
             * the lock-revocation notice) rides as a third element
             * that two-field decoders simply ignore */
            PyObject *errno_o = PyObject_GetAttrString(v, "err");
            if (!errno_o)
                return -1;
            PyObject *args = PyObject_GetAttrString(v, "args");
            PyObject *msg = NULL;
            if (args && PyTuple_Check(args) &&
                PyTuple_GET_SIZE(args) > 1) {
                msg = PyObject_Str(PyTuple_GET_ITEM(args, 1));
            } else {
                msg = PyUnicode_FromString("");
            }
            Py_XDECREF(args);
            PyObject *xd = PyObject_GetAttrString(v, "xdata");
            if (!xd)
                PyErr_Clear(); /* pre-xdata FopError: two-field shape */
            int with_xd = xd && PyDict_CheckExact(xd) &&
                          PyDict_GET_SIZE(xd) > 0;
            int rc = -1;
            if (msg && out_byte(o, T_ERR) == 0 &&
                out_byte(o, T_LIST) == 0 &&
                out_uint(o, with_xd ? 3 : 2) == 0 &&
                enc(errno_o, o, NULL) == 0 && enc(msg, o, NULL) == 0 &&
                (!with_xd || enc(xd, o, NULL) == 0))
                rc = 0;
            Py_DECREF(errno_o);
            Py_XDECREF(msg);
            Py_XDECREF(xd);
            return rc;
        }
    }
    PyErr_Format(wire_error, "unencodable type %s",
                 Py_TYPE(v)->tp_name);
    return -1;
}

/* -- decode ------------------------------------------------------------ */

typedef struct {
    const unsigned char *buf;
    Py_ssize_t len;
    Py_ssize_t pos;
    PyObject *blobs; /* [region_memoryview, offset] or NULL */
} In;

static int in_uint(In *in, unsigned long long *out)
{
    unsigned long long n = 0;
    int shift = 0;
    for (;;) {
        if (in->pos >= in->len) {
            PyErr_SetString(wire_error, "truncated varint");
            return -1;
        }
        unsigned char b = in->buf[in->pos++];
        n |= (unsigned long long)(b & 0x7F) << shift;
        if (!(b & 0x80)) {
            *out = n;
            return 0;
        }
        shift += 7;
        if (shift > 63) {
            PyErr_SetString(wire_error, "varint too long");
            return -1;
        }
    }
}

static PyObject *dec(In *in);

static PyObject *dec_via(In *in, PyObject *factory)
{
    PyObject *vals = dec(in);
    if (!vals)
        return NULL;
    PyObject *out = PyObject_CallOneArg(factory, vals);
    Py_DECREF(vals);
    return out;
}

static PyObject *dec(In *in)
{
    if (in->pos >= in->len) {
        PyErr_SetString(wire_error, "truncated record");
        return NULL;
    }
    unsigned char tag = in->buf[in->pos++];
    unsigned long long n;
    switch (tag) {
    case T_NONE:
        Py_RETURN_NONE;
    case T_TRUE:
        Py_RETURN_TRUE;
    case T_FALSE:
        Py_RETURN_FALSE;
    case T_INT:
        if (in_uint(in, &n) < 0)
            return NULL;
        return PyLong_FromUnsignedLongLong(n);
    case T_NEGINT: {
        if (in_uint(in, &n) < 0)
            return NULL;
        PyObject *p = PyLong_FromUnsignedLongLong(n);
        if (!p)
            return NULL;
        PyObject *r = PyNumber_Negative(p);
        Py_DECREF(p);
        return r;
    }
    case T_FLOAT: {
        if (in->pos + 8 > in->len) {
            PyErr_SetString(wire_error, "truncated float");
            return NULL;
        }
        unsigned long long u = 0;
        for (int i = 0; i < 8; i++)
            u = (u << 8) | in->buf[in->pos + i];
        in->pos += 8;
        union { double d; unsigned long long u; } cv;
        cv.u = u;
        return PyFloat_FromDouble(cv.d);
    }
    case T_BYTES:
        if (in_uint(in, &n) < 0)
            return NULL;
        if (in->pos + (Py_ssize_t)n > in->len) {
            PyErr_SetString(wire_error, "truncated bytes");
            return NULL;
        }
        in->pos += (Py_ssize_t)n;
        return PyBytes_FromStringAndSize(
            (const char *)in->buf + in->pos - (Py_ssize_t)n,
            (Py_ssize_t)n);
    case T_BLOBREF: {
        if (in_uint(in, &n) < 0)
            return NULL;
        if (!in->blobs || in->blobs == Py_None) {
            PyErr_SetString(wire_error,
                            "blob reference outside a FL_BLOBS record");
            return NULL;
        }
        PyObject *region = PyList_GET_ITEM(in->blobs, 0);
        PyObject *off_o = PyList_GET_ITEM(in->blobs, 1);
        Py_ssize_t off = PyLong_AsSsize_t(off_o);
        if (off < 0 && PyErr_Occurred())
            return NULL;
        Py_ssize_t rlen = PySequence_Length(region);
        if (rlen < 0)
            return NULL;
        if (off + (Py_ssize_t)n > rlen) {
            PyErr_SetString(wire_error, "blob reference beyond record");
            return NULL;
        }
        PyObject *no = PyLong_FromSsize_t(off + (Py_ssize_t)n);
        if (!no)
            return NULL;
        PyList_SetItem(in->blobs, 1, no); /* steals no */
        /* region[off:off+n] — a zero-copy memoryview slice */
        PyObject *lo = PyLong_FromSsize_t(off);
        PyObject *hi = PyLong_FromSsize_t(off + (Py_ssize_t)n);
        if (!lo || !hi) {
            Py_XDECREF(lo);
            Py_XDECREF(hi);
            return NULL;
        }
        PyObject *slice = PySlice_New(lo, hi, NULL);
        Py_DECREF(lo);
        Py_DECREF(hi);
        if (!slice)
            return NULL;
        PyObject *out = PyObject_GetItem(region, slice);
        Py_DECREF(slice);
        return out;
    }
    case T_STR:
        if (in_uint(in, &n) < 0)
            return NULL;
        if (in->pos + (Py_ssize_t)n > in->len) {
            PyErr_SetString(wire_error, "truncated str");
            return NULL;
        }
        in->pos += (Py_ssize_t)n;
        return PyUnicode_DecodeUTF8(
            (const char *)in->buf + in->pos - (Py_ssize_t)n,
            (Py_ssize_t)n, "surrogateescape");
    case T_LIST: {
        if (in_uint(in, &n) < 0)
            return NULL;
        PyObject *out = PyList_New((Py_ssize_t)n);
        if (!out)
            return NULL;
        for (Py_ssize_t i = 0; i < (Py_ssize_t)n; i++) {
            PyObject *item = dec(in);
            if (!item) {
                Py_DECREF(out);
                return NULL;
            }
            PyList_SET_ITEM(out, i, item);
        }
        return out;
    }
    case T_DICT: {
        if (in_uint(in, &n) < 0)
            return NULL;
        PyObject *d = PyDict_New();
        if (!d)
            return NULL;
        for (unsigned long long i = 0; i < n; i++) {
            PyObject *k = dec(in);
            if (!k) {
                Py_DECREF(d);
                return NULL;
            }
            PyObject *v = dec(in);
            if (!v) {
                Py_DECREF(k);
                Py_DECREF(d);
                return NULL;
            }
            int rc = PyDict_SetItem(d, k, v);
            Py_DECREF(k);
            Py_DECREF(v);
            if (rc < 0) {
                Py_DECREF(d);
                return NULL;
            }
        }
        return d;
    }
    case T_IATT:
        return dec_via(in, mk_iatt);
    case T_LOC:
        return dec_via(in, mk_loc);
    case T_FD:
        return dec_via(in, mk_fd);
    case T_ERR:
        return dec_via(in, mk_err);
    default:
        PyErr_Format(wire_error, "bad tag %d", (int)tag);
        return NULL;
    }
}

/* -- module API -------------------------------------------------------- */

static PyObject *py_register(PyObject *self, PyObject *args)
{
    PyObject *we, *stats;
    if (!PyArg_ParseTuple(args, "OOOOOOOOOOO", &cls_iatt, &cls_loc,
                          &cls_fd, &cls_err, &cls_blob, &mk_iatt,
                          &mk_loc, &mk_fd, &mk_err, &we, &stats))
        return NULL;
    Py_INCREF(cls_iatt); Py_INCREF(cls_loc); Py_INCREF(cls_fd);
    Py_INCREF(cls_err); Py_INCREF(cls_blob);
    Py_INCREF(mk_iatt); Py_INCREF(mk_loc); Py_INCREF(mk_fd);
    Py_INCREF(mk_err);
    wire_error = we;
    Py_INCREF(we);
    blob_stats = stats;
    Py_INCREF(stats);
    Py_RETURN_NONE;
}

static PyObject *py_encode(PyObject *self, PyObject *args)
{
    PyObject *payload, *blobs = Py_None;
    if (!PyArg_ParseTuple(args, "O|O", &payload, &blobs))
        return NULL;
    Out o = {NULL, 0, 0};
    if (enc(payload, &o, blobs == Py_None ? NULL : blobs) < 0) {
        PyMem_Free(o.buf);
        return NULL;
    }
    PyObject *b = PyBytes_FromStringAndSize(o.buf, o.len);
    PyMem_Free(o.buf);
    return b;
}

static PyObject *py_decode(PyObject *self, PyObject *args)
{
    Py_buffer pb;
    Py_ssize_t pos;
    PyObject *blobs = Py_None;
    if (!PyArg_ParseTuple(args, "y*n|O", &pb, &pos, &blobs))
        return NULL;
    In in = {(const unsigned char *)pb.buf, pb.len, pos,
             blobs == Py_None ? NULL : blobs};
    PyObject *v = dec(&in);
    PyBuffer_Release(&pb);
    if (!v)
        return NULL;
    PyObject *out = Py_BuildValue("(Nn)", v, in.pos);
    return out;
}

static PyMethodDef methods[] = {
    {"register", py_register, METH_VARARGS, "register classes"},
    {"encode", py_encode, METH_VARARGS, "encode value tree -> bytes"},
    {"decode", py_decode, METH_VARARGS,
     "decode (buf, pos[, blobs]) -> (value, newpos)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef mod = {
    PyModuleDef_HEAD_INIT, "_wirec", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit__wirec(void)
{
    return PyModule_Create(&mod);
}
