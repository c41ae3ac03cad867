/* Native RV64IMC tracing emulator.
 *
 * Bit-exact port of the repo's own Python emulator (zolt_tpu/vm/emulator.py,
 * decode.py, state.py, layout.py), which itself mirrors the reference tracer
 * (reference src/tracer/mod.zig:125-900). The Python emulator remains the
 * oracle: tests/test_native_emu.py runs both on the golden guests and random
 * programs and compares every trace field.
 *
 * Design: the caller (vm/native_emu.py) owns all state — RAM word array,
 * trace/mem-record buffers, register file, device buffers — so the run is
 * resumable: when a buffer fills, the call returns RV_AGAIN and the caller
 * grows the buffer and calls again. No allocation happens here.
 *
 * Trace semantics replicated exactly:
 *  - per-BYTE word-granular RAM access records (a load of N bytes appends N
 *    read records of the containing word; stores likewise with evolving
 *    pre/post), matching state.py read_byte/write_byte;
 *  - the ECALL terminating instruction records its lookup info but NOT a
 *    trace step (emulator.py step() raises before appending);
 *  - the infinite-loop heuristic (prev_pc == pc) checked before fetch;
 *  - the synthetic termination write {write, termination, 0, 1, cycle}
 *    appended on both termination kinds;
 *  - I/O-region dispatch per byte (panic region reads 1 per byte when
 *    panicked — bug-compatible with JoltDevice.load).
 */

#include <stdint.h>
#include <string.h>

typedef struct {
    uint64_t cycle;
    uint64_t pc;
    uint64_t rs1_value;
    uint64_t rs2_value;
    uint64_t rd_pre_value;
    uint64_t rd_value;
    uint64_t memory_addr;
    uint64_t memory_pre_value;
    uint64_t memory_value;
    uint64_t next_pc;
    uint32_t instruction;
    uint8_t has_memory;       /* memory_addr is not None */
    uint8_t has_mem_pre;      /* memory_pre_value is not None */
    uint8_t has_mem_val;      /* memory_value is not None */
    uint8_t is_memory_write;
    uint8_t is_compressed;
    uint8_t _pad[7];
} RvTraceRec;                  /* 96 bytes */

typedef struct {
    uint64_t address;
    uint64_t pre_value;
    uint64_t post_value;
    uint64_t timestamp;
    uint8_t is_write;
    uint8_t _pad[7];
} RvMemRec;                    /* 40 bytes */

typedef struct {
    /* layout (from vm/layout.py MemoryLayout) */
    uint64_t lowest;           /* lowest_address() */
    uint64_t window_end;       /* lowest + 8*ram_k_words (provable bound) */
    uint64_t input_start, input_end;
    uint64_t ta_start, ta_end; /* trusted advice */
    uint64_t ua_start, ua_end; /* untrusted advice */
    uint64_t output_start;     /* output region is [output_start, termination) */
    uint64_t panic_addr;
    uint64_t termination;
    uint64_t io_end;
    uint64_t ram_base;         /* word array base address (= lowest, aligned) */
    uint64_t ram_nwords;
    uint64_t max_cycles;
} RvLayout;

typedef struct {
    uint64_t regs[32];
    uint64_t pc, prev_pc, cycle;
    uint64_t outputs_len;
    uint64_t n_steps, n_mem;   /* records written so far (across resumes) */
    uint64_t fault_addr;
    /* final-ECALL lookup info (the entry with no trace step) */
    uint64_t ecall_pc, ecall_rs1, ecall_rs2, ecall_cycle;
    uint32_t ecall_instr;
    uint8_t panic;
    uint8_t term_kind;         /* 0 running, 1 ecall, 2 loop */
    uint8_t _pad[2];
} RvState;

enum { RV_DONE = 0, RV_AGAIN_TRACE = 1, RV_AGAIN_MEM = 2,
       RV_MAX_CYCLES = 3, RV_FAULT = 4, RV_BAD_PC = 5, RV_BAD_STORE = 6 };

#define JOLT_CYCLE_TRACK 0xC7C1EULL
#define JOLT_PRINT 0x5072696EULL

static inline int64_t sx(uint64_t v, int bits) {
    return ((int64_t)(v << (64 - bits))) >> (64 - bits);
}

/* ---------------- RVC expansion (port of decode.py expand_compressed) ---- */

static inline uint32_t enc_i(uint32_t imm, uint32_t rs1, uint32_t f3,
                             uint32_t rd, uint32_t op) {
    return ((imm & 0xFFF) << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op;
}
static inline uint32_t enc_r(uint32_t f7, uint32_t rs2, uint32_t rs1,
                             uint32_t f3, uint32_t rd, uint32_t op) {
    return (f7 << 25) | (rs2 << 20) | (rs1 << 15) | (f3 << 12) | (rd << 7) | op;
}
static inline uint32_t enc_s(uint32_t imm, uint32_t rs2, uint32_t rs1,
                             uint32_t f3, uint32_t op) {
    return (((imm >> 5) & 0x7F) << 25) | (rs2 << 20) | (rs1 << 15)
         | (f3 << 12) | ((imm & 0x1F) << 7) | op;
}
static inline uint32_t enc_b(uint32_t imm, uint32_t rs2, uint32_t rs1,
                             uint32_t f3, uint32_t op) {
    return (((imm >> 12) & 1) << 31) | (((imm >> 5) & 0x3F) << 25)
         | (rs2 << 20) | (rs1 << 15) | (f3 << 12)
         | (((imm >> 1) & 0xF) << 8) | (((imm >> 11) & 1) << 7) | op;
}
static inline uint32_t enc_j(uint32_t imm, uint32_t rd, uint32_t op) {
    return (((imm >> 20) & 1) << 31) | (((imm >> 1) & 0x3FF) << 21)
         | (((imm >> 11) & 1) << 20) | (((imm >> 12) & 0xFF) << 12)
         | (rd << 7) | op;
}
static inline uint32_t enc_u(uint32_t imm20, uint32_t rd, uint32_t op) {
    return ((imm20 & 0xFFFFF) << 12) | (rd << 7) | op;
}

static uint32_t expand_compressed(uint32_t hw) {
    hw &= 0xFFFF;
    uint32_t quadrant = hw & 0x3;
    uint32_t funct3 = (hw >> 13) & 0x7;

    if (quadrant == 0) {
        uint32_t rdp = ((hw >> 2) & 0x7) + 8;
        uint32_t rs1p = ((hw >> 7) & 0x7) + 8;
        if (funct3 == 0) { /* C.ADDI4SPN */
            uint32_t imm = (((hw >> 5) & 1) << 3) | (((hw >> 6) & 1) << 2)
                         | (((hw >> 7) & 0xF) << 6) | (((hw >> 11) & 0x3) << 4);
            if (imm == 0) return 0;
            return enc_i(imm, 2, 0, rdp, 0x13);
        }
        if (funct3 == 2) { /* C.LW */
            uint32_t imm = (((hw >> 5) & 1) << 6) | (((hw >> 6) & 1) << 2)
                         | (((hw >> 10) & 0x7) << 3);
            return enc_i(imm, rs1p, 2, rdp, 0x03);
        }
        if (funct3 == 3) { /* C.LD */
            uint32_t imm = (((hw >> 5) & 0x3) << 6) | (((hw >> 10) & 0x7) << 3);
            return enc_i(imm, rs1p, 3, rdp, 0x03);
        }
        if (funct3 == 6) { /* C.SW */
            uint32_t imm = (((hw >> 5) & 1) << 6) | (((hw >> 6) & 1) << 2)
                         | (((hw >> 10) & 0x7) << 3);
            return enc_s(imm, rdp, rs1p, 2, 0x23);
        }
        if (funct3 == 7) { /* C.SD */
            uint32_t imm = (((hw >> 5) & 0x3) << 6) | (((hw >> 10) & 0x7) << 3);
            return enc_s(imm, rdp, rs1p, 3, 0x23);
        }
        return 0;
    }

    if (quadrant == 1) {
        uint32_t rd = (hw >> 7) & 0x1F;
        uint32_t rdp = ((hw >> 7) & 0x7) + 8;
        uint32_t rs2p = ((hw >> 2) & 0x7) + 8;
        int64_t imm6 = sx((((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F), 6);
        if (funct3 == 0) return enc_i((uint32_t)imm6 & 0xFFF, rd, 0, rd, 0x13);
        if (funct3 == 1) return enc_i((uint32_t)imm6 & 0xFFF, rd, 0, rd, 0x1B);
        if (funct3 == 2) return enc_i((uint32_t)imm6 & 0xFFF, 0, 0, rd, 0x13);
        if (funct3 == 3) {
            if (rd == 2) { /* C.ADDI16SP */
                int64_t imm = sx((((hw >> 12) & 1) << 9) | (((hw >> 6) & 1) << 4)
                               | (((hw >> 5) & 1) << 6) | (((hw >> 3) & 0x3) << 7)
                               | (((hw >> 2) & 1) << 5), 10);
                return enc_i((uint32_t)imm & 0xFFF, 2, 0, 2, 0x13);
            }
            return enc_u((uint32_t)imm6 & 0xFFFFF, rd, 0x37); /* C.LUI */
        }
        if (funct3 == 4) {
            uint32_t f2 = (hw >> 10) & 0x3;
            if (f2 == 0) { /* C.SRLI */
                uint32_t shamt = (((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F);
                return enc_i(shamt, rdp, 5, rdp, 0x13);
            }
            if (f2 == 1) { /* C.SRAI */
                uint32_t shamt = (((hw >> 12) & 1) << 5) | ((hw >> 2) & 0x1F);
                return enc_i(0x400 | shamt, rdp, 5, rdp, 0x13);
            }
            if (f2 == 2) /* C.ANDI */
                return enc_i((uint32_t)imm6 & 0xFFF, rdp, 7, rdp, 0x13);
            uint32_t bit12 = (hw >> 12) & 1;
            uint32_t f2b = (hw >> 5) & 0x3;
            if (bit12 == 0) {
                if (f2b == 0) return enc_r(0x20, rs2p, rdp, 0, rdp, 0x33);
                if (f2b == 1) return enc_r(0, rs2p, rdp, 4, rdp, 0x33);
                if (f2b == 2) return enc_r(0, rs2p, rdp, 6, rdp, 0x33);
                return enc_r(0, rs2p, rdp, 7, rdp, 0x33);
            }
            if (f2b == 0) return enc_r(0x20, rs2p, rdp, 0, rdp, 0x3B);
            if (f2b == 1) return enc_r(0, rs2p, rdp, 0, rdp, 0x3B);
            return 0;
        }
        if (funct3 == 5) { /* C.J */
            int64_t imm = sx((((hw >> 12) & 1) << 11) | (((hw >> 11) & 1) << 4)
                           | (((hw >> 9) & 0x3) << 8) | (((hw >> 8) & 1) << 10)
                           | (((hw >> 7) & 1) << 6) | (((hw >> 6) & 1) << 7)
                           | (((hw >> 3) & 0x7) << 1) | (((hw >> 2) & 1) << 5), 12);
            return enc_j((uint32_t)imm & 0x1FFFFF, 0, 0x6F);
        }
        if (funct3 == 6 || funct3 == 7) { /* C.BEQZ / C.BNEZ */
            int64_t imm = sx((((hw >> 12) & 1) << 8) | (((hw >> 10) & 0x3) << 3)
                           | (((hw >> 5) & 0x3) << 6) | (((hw >> 3) & 0x3) << 1)
                           | (((hw >> 2) & 1) << 5), 9);
            uint32_t f3 = (funct3 == 6) ? 0 : 1;
            return enc_b((uint32_t)imm & 0x1FFF, 0, rdp, f3, 0x63);
        }
        return 0;
    }

    if (quadrant == 2) {
        uint32_t rd = (hw >> 7) & 0x1F;
        uint32_t rs2 = (hw >> 2) & 0x1F;
        uint32_t bit12 = (hw >> 12) & 1;
        if (funct3 == 0) { /* C.SLLI */
            uint32_t shamt = (bit12 << 5) | ((hw >> 2) & 0x1F);
            return enc_i(shamt, rd, 1, rd, 0x13);
        }
        if (funct3 == 2) { /* C.LWSP */
            uint32_t imm = (bit12 << 5) | (((hw >> 4) & 0x7) << 2)
                         | (((hw >> 2) & 0x3) << 6);
            return enc_i(imm, 2, 2, rd, 0x03);
        }
        if (funct3 == 3) { /* C.LDSP */
            uint32_t imm = (bit12 << 5) | (((hw >> 5) & 0x3) << 3)
                         | (((hw >> 2) & 0x7) << 6);
            return enc_i(imm, 2, 3, rd, 0x03);
        }
        if (funct3 == 4) {
            if (bit12 == 0) {
                if (rs2 == 0) return enc_i(0, rd, 0, 0, 0x67);  /* C.JR */
                return enc_r(0, rs2, 0, 0, rd, 0x33);           /* C.MV */
            }
            if (rs2 == 0) {
                if (rd == 0) return 0x00100073;                  /* C.EBREAK */
                return enc_i(0, rd, 0, 1, 0x67);                 /* C.JALR */
            }
            return enc_r(0, rs2, rd, 0, rd, 0x33);               /* C.ADD */
        }
        if (funct3 == 6) { /* C.SWSP */
            uint32_t imm = (((hw >> 9) & 0xF) << 2) | (((hw >> 7) & 0x3) << 6);
            return enc_s(imm, rs2, 2, 2, 0x23);
        }
        if (funct3 == 7) { /* C.SDSP */
            uint32_t imm = (((hw >> 10) & 0x7) << 3) | (((hw >> 7) & 0x7) << 6);
            return enc_s(imm, rs2, 2, 3, 0x23);
        }
        return 0;
    }
    return 0;
}

/* ---------------- device + memory helpers -------------------------------- */

typedef struct {
    const RvLayout *lay;
    uint64_t *ram;             /* word array starting at lay->ram_base */
    const uint8_t *inputs;   uint64_t inputs_len;
    const uint8_t *tadvice;  uint64_t ta_len;
    const uint8_t *uadvice;  uint64_t ua_len;
    uint8_t *outputs;          /* capacity termination - output_start */
    RvState *st;
    RvTraceRec *trace; uint64_t trace_cap;
    RvMemRec *mem;     uint64_t mem_cap;
} Ctx;

static inline int is_io(const RvLayout *l, uint64_t a) {
    /* any of input/output/advice/panic/termination regions */
    return (a >= l->input_start && a < l->input_end)
        || (a >= l->output_start && a < l->termination)
        || (a >= l->ta_start && a < l->ta_end)
        || (a >= l->ua_start && a < l->ua_end)
        || (a >= l->panic_addr && a < l->termination)
        || (a >= l->termination && a < l->io_end);
}

static inline uint8_t dev_load(Ctx *c, uint64_t a) {
    const RvLayout *l = c->lay;
    if (a >= l->panic_addr && a < l->termination) return c->st->panic ? 1 : 0;
    if (a >= l->termination && a < l->io_end) return 0;
    if (a >= l->input_start && a < l->input_end) {
        uint64_t i = a - l->input_start;
        return i < c->inputs_len ? c->inputs[i] : 0;
    }
    if (a >= l->ta_start && a < l->ta_end) {
        uint64_t i = a - l->ta_start;
        return i < c->ta_len ? c->tadvice[i] : 0;
    }
    if (a >= l->ua_start && a < l->ua_end) {
        uint64_t i = a - l->ua_start;
        return i < c->ua_len ? c->uadvice[i] : 0;
    }
    if (a >= l->output_start && a < l->termination) {
        uint64_t i = a - l->output_start;
        return i < c->st->outputs_len ? c->outputs[i] : 0;
    }
    return 0;
}

static inline int dev_store(Ctx *c, uint64_t a, uint8_t v) {
    const RvLayout *l = c->lay;
    if (a == l->panic_addr) { c->st->panic = 1; return 0; }
    if (a >= l->panic_addr && a < l->io_end) return 0;
    if (a < l->output_start) return -1;  /* Python would index from the end */
    uint64_t i = a - l->output_start;
    c->outputs[i] = v;
    if (i + 1 > c->st->outputs_len) c->st->outputs_len = i + 1;
    return 0;
}

static inline int in_window(const RvLayout *l, uint64_t a) {
    return a >= l->lowest && a < l->window_end;
}

static inline uint64_t *word_ptr(Ctx *c, uint64_t a) {
    uint64_t w = (a & ~7ULL);
    if (w < c->lay->ram_base) return 0;
    uint64_t idx = (w - c->lay->ram_base) >> 3;
    if (idx >= c->lay->ram_nwords) return 0;
    return &c->ram[idx];
}

static inline int mem_push(Ctx *c, uint64_t addr, uint64_t pre, uint64_t post,
                           uint64_t ts, uint8_t is_write) {
    if (c->st->n_mem >= c->mem_cap) return -1;
    RvMemRec *r = &c->mem[c->st->n_mem++];
    r->address = addr; r->pre_value = pre; r->post_value = post;
    r->timestamp = ts; r->is_write = is_write;
    r->_pad[0] = r->_pad[1] = r->_pad[2] = r->_pad[3] = r->_pad[4]
        = r->_pad[5] = r->_pad[6] = 0;
    return 0;
}

/* traced byte read (state.py read_byte via _read_byte_io) */
static inline int rd_byte_io(Ctx *c, uint64_t a, uint8_t *out, int *fault) {
    if (is_io(c->lay, a)) { *out = dev_load(c, a); return 0; }
    if (!in_window(c->lay, a)) { *fault = 1; c->st->fault_addr = a; return -1; }
    uint64_t *w = word_ptr(c, a);
    uint64_t v = w ? *w : 0;
    if (mem_push(c, a & ~7ULL, v, v, c->st->cycle, 0)) return -2;
    *out = (uint8_t)(v >> ((a & 7) * 8));
    return 0;
}

/* traced byte write (state.py write_byte via _write_byte_io) */
static inline int wr_byte_io(Ctx *c, uint64_t a, uint8_t v, int *fault) {
    if (is_io(c->lay, a)) {
        if (dev_store(c, a, v)) { *fault = 2; c->st->fault_addr = a; return -1; }
        return 0;
    }
    if (!in_window(c->lay, a)) { *fault = 1; c->st->fault_addr = a; return -1; }
    uint64_t *w = word_ptr(c, a);
    if (!w) { *fault = 1; c->st->fault_addr = a; return -1; }
    uint64_t pre = *w;
    uint64_t off = (a & 7) * 8;
    uint64_t mask = 0xFFULL << off;
    uint64_t post = (pre & ~mask) | ((uint64_t)v << off);
    *w = post;
    if (mem_push(c, a & ~7ULL, pre, post, c->st->cycle, 1)) return -2;
    return 0;
}

/* untraced byte read (fetch / store pre-value capture) */
static inline uint8_t rd_byte_untraced(Ctx *c, uint64_t a) {
    uint64_t *w = word_ptr(c, a);
    uint64_t v = w ? *w : 0;
    return (uint8_t)(v >> ((a & 7) * 8));
}

/* ---------------- main stepper ------------------------------------------- */

int rv64_run(const RvLayout *lay, uint64_t *ram,
             const uint8_t *inputs, uint64_t inputs_len,
             const uint8_t *tadvice, uint64_t ta_len,
             const uint8_t *uadvice, uint64_t ua_len,
             uint8_t *outputs,
             RvState *st,
             RvTraceRec *trace, uint64_t trace_cap,
             RvMemRec *mem, uint64_t mem_cap) {
    Ctx c = { lay, ram, inputs, inputs_len, tadvice, ta_len, uadvice, ua_len,
              outputs, st, trace, trace_cap, mem, mem_cap };

    while (st->cycle < lay->max_cycles) {
        if (st->prev_pc != 0 && st->prev_pc == st->pc) {
            /* infinite-loop termination + synthetic termination write */
            if (mem_push(&c, lay->termination, 0, 1, st->cycle, 1))
                return RV_AGAIN_MEM;
            st->term_kind = 2;
            return RV_DONE;
        }
        if (st->n_steps >= trace_cap) return RV_AGAIN_TRACE;
        /* worst case one step appends 16 mem records (8 pre-read bytes are
         * untraced; 8 traced write bytes + possible 8 traced read bytes) */
        if (st->n_mem + 16 > mem_cap) return RV_AGAIN_MEM;

        /* fetch */
        uint64_t pc = st->pc;
        if (!word_ptr(&c, pc)) return RV_BAD_PC;
        uint32_t hw = rd_byte_untraced(&c, pc)
                    | ((uint32_t)rd_byte_untraced(&c, pc + 1) << 8);
        int compressed = (hw & 0x3) != 0x3;
        uint32_t instr;
        if (compressed) {
            instr = expand_compressed(hw);
        } else {
            instr = hw | ((uint32_t)rd_byte_untraced(&c, pc + 2) << 16)
                       | ((uint32_t)rd_byte_untraced(&c, pc + 3) << 24);
        }

        uint32_t opcode = instr & 0x7F;
        uint32_t rd = (instr >> 7) & 0x1F;
        uint32_t f3 = (instr >> 12) & 0x7;
        uint32_t rs1 = (instr >> 15) & 0x1F;
        uint32_t rs2 = (instr >> 20) & 0x1F;
        uint32_t f7 = (instr >> 25) & 0x7F;

        int64_t imm = 0;
        switch (opcode) {
        case 0x37: case 0x17: imm = sx(instr & 0xFFFFF000u, 32); break;
        case 0x6F:
            imm = sx((((uint64_t)(instr >> 31) & 1) << 20)
                   | (((uint64_t)(instr >> 21) & 0x3FF) << 1)
                   | (((uint64_t)(instr >> 20) & 1) << 11)
                   | (((uint64_t)(instr >> 12) & 0xFF) << 12), 21);
            break;
        case 0x67: case 0x03: case 0x13: case 0x1B: case 0x73: case 0x0F:
            imm = sx((instr >> 20) & 0xFFF, 12); break;
        case 0x23:
            imm = sx((((uint64_t)(instr >> 25) & 0x7F) << 5)
                   | ((instr >> 7) & 0x1F), 12);
            break;
        case 0x63:
            imm = sx((((uint64_t)(instr >> 31) & 1) << 12)
                   | (((uint64_t)(instr >> 7) & 1) << 11)
                   | (((uint64_t)(instr >> 25) & 0x3F) << 5)
                   | (((uint64_t)(instr >> 8) & 0xF) << 1), 13);
            break;
        default: imm = 0; break;
        }

        uint64_t rs1_value = rs1 ? st->regs[rs1] : 0;
        uint64_t rs2_value = rs2 ? st->regs[rs2] : 0;
        uint64_t rd_pre_value = rd ? st->regs[rd] : 0;

        uint64_t pc_inc = compressed ? 2 : 4;
        uint64_t rd_value = 0;
        uint64_t next_pc = pc + pc_inc;
        uint64_t memory_addr = 0, memory_pre = 0, memory_val = 0;
        int has_memory = 0, has_mem_pre = 0, has_mem_val = 0, is_write = 0;
        int wr_rd = 0;
        int fault = 0;

        switch (opcode) {
        case 0x37:  /* LUI */
            rd_value = (uint64_t)imm; wr_rd = 1; break;
        case 0x17:  /* AUIPC */
            rd_value = pc + (uint64_t)imm; wr_rd = 1; break;
        case 0x6F:  /* JAL */
            rd_value = pc + pc_inc; next_pc = pc + (uint64_t)imm; wr_rd = 1; break;
        case 0x67:  /* JALR */
            rd_value = pc + pc_inc;
            next_pc = (rs1_value + (uint64_t)imm) & ~1ULL;
            wr_rd = 1; break;
        case 0x63: { /* BRANCH */
            int taken = 0;
            switch (f3) {
            case 0: taken = rs1_value == rs2_value; break;
            case 1: taken = rs1_value != rs2_value; break;
            case 4: taken = (int64_t)rs1_value < (int64_t)rs2_value; break;
            case 5: taken = (int64_t)rs1_value >= (int64_t)rs2_value; break;
            case 6: taken = rs1_value < rs2_value; break;
            case 7: taken = rs1_value >= rs2_value; break;
            default: taken = 0; break;
            }
            if (taken) next_pc = pc + (uint64_t)imm;
            break;
        }
        case 0x03: { /* LOAD */
            uint64_t addr = rs1_value + (uint64_t)imm;
            memory_addr = addr; has_memory = 1;
            uint64_t value = 0;
            int nb = 0, sign_bits = 0;
            switch (f3) {
            case 0: nb = 1; sign_bits = 8; break;   /* LB */
            case 4: nb = 1; sign_bits = 0; break;   /* LBU */
            case 1: nb = 2; sign_bits = 16; break;  /* LH */
            case 5: nb = 2; sign_bits = 0; break;   /* LHU */
            case 2: nb = 4; sign_bits = 32; break;  /* LW */
            case 6: nb = 4; sign_bits = 0; break;   /* LWU */
            case 3: nb = 8; sign_bits = 0; break;   /* LD */
            default: nb = 0; break;
            }
            for (int i = 0; i < nb; i++) {
                uint8_t b;
                int rc = rd_byte_io(&c, addr + i, &b, &fault);
                if (rc == -2) return RV_AGAIN_MEM;
                if (rc) goto faulted;
                value |= (uint64_t)b << (8 * i);
            }
            if (sign_bits) value = (uint64_t)sx(value, sign_bits);
            rd_value = value; memory_val = value; has_mem_val = 1; wr_rd = 1;
            break;
        }
        case 0x23: { /* STORE */
            uint64_t addr = rs1_value + (uint64_t)imm;
            memory_addr = addr; has_memory = 1; is_write = 1;
            int nb = 0;
            switch (f3) {
            case 0: nb = 1; break; case 1: nb = 2; break;
            case 2: nb = 4; break; case 3: nb = 8; break;
            default: nb = 0; break;
            }
            if (nb) {
                uint64_t pre = 0;
                for (int i = 0; i < nb; i++) {
                    uint64_t a_i = addr + i;
                    uint8_t b = is_io(lay, a_i) ? dev_load(&c, a_i)
                                                : rd_byte_untraced(&c, a_i);
                    pre |= (uint64_t)b << (8 * i);
                }
                memory_pre = pre; has_mem_pre = 1;
                for (int i = 0; i < nb; i++) {
                    int rc = wr_byte_io(&c, addr + i,
                                        (uint8_t)(rs2_value >> (8 * i)), &fault);
                    if (rc == -2) return RV_AGAIN_MEM;
                    if (rc) goto faulted;
                }
                memory_val = (nb == 8) ? rs2_value
                           : (rs2_value & ((1ULL << (8 * nb)) - 1));
                has_mem_val = 1;
            }
            break;
        }
        case 0x13: { /* OP-IMM */
            uint64_t uimm = (uint64_t)imm;
            uint64_t v = 0;
            switch (f3) {
            case 0: v = rs1_value + uimm; break;
            case 2: v = ((int64_t)rs1_value < imm) ? 1 : 0; break;
            case 3: v = (rs1_value < uimm) ? 1 : 0; break;
            case 4: v = rs1_value ^ uimm; break;
            case 6: v = rs1_value | uimm; break;
            case 7: v = rs1_value & uimm; break;
            case 1: v = rs1_value << (imm & 0x3F); break;
            case 5: {
                int sh = imm & 0x3F;
                v = (f7 & 0x20) ? (uint64_t)((int64_t)rs1_value >> sh)
                                : rs1_value >> sh;
                break;
            }
            }
            rd_value = v; wr_rd = 1; break;
        }
        case 0x33: { /* OP */
            uint64_t v = 0;
            if (f7 == 1) { /* M */
                int64_t s1 = (int64_t)rs1_value, s2 = (int64_t)rs2_value;
                switch (f3) {
                case 0: v = rs1_value * rs2_value; break;
                case 1: v = (uint64_t)((__int128)s1 * s2 >> 64); break;
                case 2:
                    /* MULHSU: signed x unsigned; uint64 -> __int128 is a
                     * value-preserving zero extension, product stays signed */
                    v = (uint64_t)(((__int128)s1 * (__int128)rs2_value) >> 64);
                    break;
                case 3: v = (uint64_t)(((unsigned __int128)rs1_value * rs2_value) >> 64); break;
                case 4:
                    if (rs2_value == 0) v = ~0ULL;
                    else if (s1 == INT64_MIN && s2 == -1) v = rs1_value;
                    else v = (uint64_t)(s1 / s2);
                    break;
                case 5: v = rs2_value == 0 ? ~0ULL : rs1_value / rs2_value; break;
                case 6:
                    if (rs2_value == 0) v = rs1_value;
                    else if (s1 == INT64_MIN && s2 == -1) v = 0;
                    else v = (uint64_t)(s1 % s2);
                    break;
                default: v = rs2_value == 0 ? rs1_value : rs1_value % rs2_value; break;
                }
            } else {
                switch (f3) {
                case 0: v = (f7 & 0x20) ? rs1_value - rs2_value
                                        : rs1_value + rs2_value; break;
                case 1: v = rs1_value << (rs2_value & 0x3F); break;
                case 2: v = ((int64_t)rs1_value < (int64_t)rs2_value) ? 1 : 0; break;
                case 3: v = (rs1_value < rs2_value) ? 1 : 0; break;
                case 4: v = rs1_value ^ rs2_value; break;
                case 5: {
                    int sh = rs2_value & 0x3F;
                    v = (f7 & 0x20) ? (uint64_t)((int64_t)rs1_value >> sh)
                                    : rs1_value >> sh;
                    break;
                }
                case 6: v = rs1_value | rs2_value; break;
                default: v = rs1_value & rs2_value; break;
                }
            }
            rd_value = v; wr_rd = 1; break;
        }
        case 0x1B: { /* OP-IMM-32 */
            uint32_t r32 = (uint32_t)rs1_value;
            uint64_t v = 0;
            switch (f3) {
            case 0: v = (uint64_t)(int64_t)(int32_t)(r32 + (uint32_t)imm); break;
            case 1: v = (uint64_t)(int64_t)(int32_t)(r32 << (imm & 0x1F)); break;
            case 5: {
                int sh = imm & 0x1F;
                v = (f7 & 0x20) ? (uint64_t)(int64_t)((int32_t)r32 >> sh)
                                : (uint64_t)(int64_t)(int32_t)(r32 >> sh);
                break;
            }
            default: v = 0; break;
            }
            rd_value = v; wr_rd = 1; break;
        }
        case 0x3B: { /* OP-32 */
            uint32_t r1 = (uint32_t)rs1_value, r2 = (uint32_t)rs2_value;
            int32_t s1 = (int32_t)r1, s2 = (int32_t)r2;
            uint64_t v = 0;
            if (f7 == 1) {
                switch (f3) {
                case 0: v = (uint64_t)(int64_t)(int32_t)((int64_t)s1 * s2); break;
                case 4:
                    if (s2 == 0) v = (uint64_t)(int64_t)-1;
                    else if (s1 == INT32_MIN && s2 == -1) v = (uint64_t)(int64_t)s1;
                    else v = (uint64_t)(int64_t)(int32_t)(s1 / s2);
                    break;
                case 5: v = r2 == 0 ? (uint64_t)(int64_t)(int32_t)0xFFFFFFFF
                                    : (uint64_t)(int64_t)(int32_t)(r1 / r2); break;
                case 6:
                    if (s2 == 0) v = (uint64_t)(int64_t)s1;
                    else if (s1 == INT32_MIN && s2 == -1) v = 0;
                    else v = (uint64_t)(int64_t)(int32_t)(s1 % s2);
                    break;
                case 7: v = r2 == 0 ? (uint64_t)(int64_t)(int32_t)r1
                                    : (uint64_t)(int64_t)(int32_t)(r1 % r2); break;
                default: v = 0; break;
                }
            } else {
                switch (f3) {
                case 0: v = (f7 & 0x20)
                        ? (uint64_t)(int64_t)(int32_t)(s1 - s2)
                        : (uint64_t)(int64_t)(int32_t)(s1 + s2); break;
                case 1: v = (uint64_t)(int64_t)(int32_t)(r1 << (r2 & 0x1F)); break;
                case 5: {
                    int sh = r2 & 0x1F;
                    v = (f7 & 0x20) ? (uint64_t)(int64_t)(s1 >> sh)
                                    : (uint64_t)(int64_t)(int32_t)(r1 >> sh);
                    break;
                }
                default: v = 0; break;
                }
            }
            rd_value = v; wr_rd = 1; break;
        }
        case 0x73: { /* SYSTEM */
            uint32_t funct12 = (uint32_t)imm & 0xFFF;
            if (funct12 == 0) { /* ECALL */
                uint64_t a0 = st->regs[10], a7 = st->regs[17];
                if (a0 == JOLT_CYCLE_TRACK || a7 == JOLT_CYCLE_TRACK
                    || a0 == JOLT_PRINT || a7 == JOLT_PRINT) {
                    /* tracked/print ecall: NOP step */
                } else {
                    /* terminating ECALL: lookup info recorded, NO trace step,
                     * cycle += 1, synthetic termination write */
                    st->ecall_pc = pc; st->ecall_instr = instr;
                    st->ecall_rs1 = rs1_value; st->ecall_rs2 = rs2_value;
                    st->ecall_cycle = st->cycle;
                    st->cycle += 1;
                    if (mem_push(&c, lay->termination, 0, 1, st->cycle, 1))
                        return RV_AGAIN_MEM;
                    st->term_kind = 1;
                    return RV_DONE;
                }
            }
            break;
        }
        default: /* MISC_MEM / unknown: NOP */ break;
        }

        if (0) {
faulted:
            if (fault == 2) return RV_BAD_STORE;
            return RV_FAULT;
        }

        if (wr_rd && rd != 0) st->regs[rd] = rd_value;

        RvTraceRec *t = &trace[st->n_steps++];
        t->cycle = st->cycle; t->pc = pc; t->instruction = instr;
        t->rs1_value = rs1_value; t->rs2_value = rs2_value;
        t->rd_pre_value = rd_pre_value;
        t->rd_value = rd_value;
        t->memory_addr = memory_addr; t->memory_pre_value = memory_pre;
        t->memory_value = memory_val; t->next_pc = next_pc;
        t->has_memory = (uint8_t)has_memory;
        t->has_mem_pre = (uint8_t)has_mem_pre;
        t->has_mem_val = (uint8_t)has_mem_val;
        t->is_memory_write = (uint8_t)is_write;
        t->is_compressed = (uint8_t)compressed;
        memset(t->_pad, 0, sizeof t->_pad);

        st->prev_pc = pc;
        st->pc = next_pc;
        st->cycle += 1;
    }
    return RV_MAX_CYCLES;
}
