/* C materializer for the native emulator's trace buffers.
 *
 * Converts the raw RvTraceRec / RvMemRec arrays written by rv64.c into
 * Python lists of TraceStep / MemoryAccess namedtuples ~6x faster than a
 * Python-level comprehension (no per-field attribute machinery, shared
 * PC int objects, small-int cache reuse).
 *
 * Loaded with ctypes.PyDLL (keeps the GIL: every line here touches the
 * CPython API). The namedtuple classes are passed in from Python so the
 * created objects ARE vm.emulator.TraceStep / vm.state.MemoryAccess —
 * downstream code cannot tell which tier built them.
 *
 * Subtype-tuple creation: tp_alloc(cls, n) gives a GC-tracked tuple subtype
 * whose ob_item slots start NULL; tupletraverse Py_VISITs NULL-safely, so
 * filling the slots afterwards is safe even if allocation triggers GC.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

typedef struct {
    uint64_t cycle, pc, rs1_value, rs2_value, rd_pre_value, rd_value;
    uint64_t memory_addr, memory_pre_value, memory_value, next_pc;
    uint32_t instruction;
    uint8_t has_memory, has_mem_pre, has_mem_val, is_memory_write,
            is_compressed;
    uint8_t _pad[7];
} RvTraceRec;

typedef struct {
    uint64_t address, pre_value, post_value, timestamp;
    uint8_t is_write;
    uint8_t _pad[7];
} RvMemRec;

static inline PyObject *u64(uint64_t v) {
    return PyLong_FromUnsignedLongLong(v);
}

static inline PyObject *alloc_row(PyTypeObject *tp, Py_ssize_t n) {
    return tp->tp_alloc(tp, n);
}

/* TraceStep(cycle, pc, unexpanded_pc, instruction, rs1_value, rs2_value,
 *           rd_pre_value, rd_value, memory_addr, memory_pre_value,
 *           memory_value, is_memory_write, next_pc, is_compressed, is_noop,
 *           seq_pos) — native rows are never virtual: seq_pos = 0 */
PyObject *trace_materialize(PyObject *cls, const uint8_t *buf, Py_ssize_t n) {
    PyTypeObject *tp = (PyTypeObject *)cls;
    PyObject *list = PyList_New(n);
    if (!list) return NULL;
    const RvTraceRec *recs = (const RvTraceRec *)buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        const RvTraceRec *r = &recs[i];
        PyObject *t = alloc_row(tp, 16);
        if (!t) { Py_DECREF(list); return NULL; }
        PyObject **it = ((PyTupleObject *)t)->ob_item;
        PyObject *pc = u64(r->pc);
        it[0] = u64(r->cycle);
        it[1] = pc;
        Py_INCREF(pc);
        it[2] = pc;                     /* unexpanded_pc == pc (no virtual seq) */
        it[3] = u64(r->instruction);
        it[4] = u64(r->rs1_value);
        it[5] = u64(r->rs2_value);
        it[6] = u64(r->rd_pre_value);
        it[7] = u64(r->rd_value);
        if (r->has_memory) it[8] = u64(r->memory_addr);
        else { Py_INCREF(Py_None); it[8] = Py_None; }
        if (r->has_mem_pre) it[9] = u64(r->memory_pre_value);
        else { Py_INCREF(Py_None); it[9] = Py_None; }
        if (r->has_mem_val) it[10] = u64(r->memory_value);
        else { Py_INCREF(Py_None); it[10] = Py_None; }
        it[11] = PyBool_FromLong(r->is_memory_write);
        it[12] = u64(r->next_pc);
        it[13] = PyBool_FromLong(r->is_compressed);
        it[14] = PyBool_FromLong(0);    /* is_noop */
        it[15] = u64(0);                /* seq_pos */
        PyList_SET_ITEM(list, i, t);
    }
    return list;
}

/* MemoryAccess(op, address, pre_value, post_value, timestamp) */
PyObject *mem_materialize(PyObject *cls, const uint8_t *buf, Py_ssize_t n) {
    PyTypeObject *tp = (PyTypeObject *)cls;
    PyObject *list = PyList_New(n);
    if (!list) return NULL;
    PyObject *rd = PyUnicode_InternFromString("read");
    PyObject *wr = PyUnicode_InternFromString("write");
    if (!rd || !wr) { Py_XDECREF(rd); Py_XDECREF(wr); Py_DECREF(list); return NULL; }
    const RvMemRec *recs = (const RvMemRec *)buf;
    for (Py_ssize_t i = 0; i < n; i++) {
        const RvMemRec *r = &recs[i];
        PyObject *t = alloc_row(tp, 5);
        if (!t) { Py_DECREF(rd); Py_DECREF(wr); Py_DECREF(list); return NULL; }
        PyObject **it = ((PyTupleObject *)t)->ob_item;
        PyObject *op = r->is_write ? wr : rd;
        Py_INCREF(op);
        it[0] = op;
        it[1] = u64(r->address);
        it[2] = u64(r->pre_value);
        it[3] = u64(r->post_value);
        it[4] = u64(r->timestamp);
        PyList_SET_ITEM(list, i, t);
    }
    Py_DECREF(rd);
    Py_DECREF(wr);
    return list;
}
