// Flash-decode attention: one query token per sequence against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_kernel`
// (kernels/decode_attn/decode_attn.py of the JAX package): for q (B, H, d)
// and a cache k, v (B, S, Hkv, d) whose first `length` slots are valid, it
// returns softmax(softcap(q . k * scale)) . v per query head, the G = H /
// Hkv query heads of a KV head sharing that head's cache (GQA), in q's
// type with float32 accumulation.
//
// What bounds it on an H100: bytes. Every valid cache slot is read once,
// 2 * B * length * Hkv * d * elt bytes in all; the arithmetic is 4 * G * d
// flops per slot, far below the card's rate. Only the valid prefix [0,
// length) is read, which gives the reference's answer (it masks the other
// slots to -1e30 and their weight underflows to 0).
//
// What held the first design back: each warp loaded its slots' K and V
// rows straight into registers and only then computed, so no load was in
// flight during the compute; the rows in registers cost 126 registers at
// (bf16, d 256, G <= 2), so few warps fit on an SM; every slot's dot
// product was closed by five dependent shuffles; a lane owned d / 32
// elements, which refused d = 112; and the split count aimed at four
// blocks an SM without knowing how many fit, so the grid at 32K slots ran
// a second, nearly empty wave. It reached 36 % of the bound at decode_32k.
//
// This design. One thread block takes one (split, KV head, sequence) and
// walks its chunk of the prefix in tiles of 32 slots:
//
// - A ring of 3 or 4 stages in shared memory holds the K and V tiles (32 x
//   d each). `cp.async.cg` 16-byte copies (with an L2 256-byte prefetch
//   hint, faster at decode_32k) fill it, one commit group a tile, so two or
//   three tiles are in flight while one is computed. A row is padded to an
//   odd number of 16-byte chunks, so the eight rows an 8-lane phase or an
//   ldmatrix reads at one chunk column hit eight different bank groups (no
//   swizzle, any d). K and V never sit in registers.
// - bf16 cache (the serving path), `decode_attn_mma`, 4 warps: the
//   products run on the tensor cores (mma.sync m16n8k16, bf16 in, float32
//   sums), the G <= 8 query heads as the rows of the A operand. Scores S =
//   Q . K^T take K's rows as the col-major B operand as they lie (ldmatrix),
//   warp w slots 8w .. 8w + 7; one online-softmax rescale a tile (max and
//   sum across the four warps through shared memory; `tanhf` softcap and
//   `expf`, no fast intrinsics); O += P . V with V's rows transposed by
//   ldmatrix, warp w the 8-column tiles w, w + 4, ... of d. The bf16 cache
//   is exact in the mma; q and p are cut into 1 - 3 bf16 terms (3 for
//   float32 queries: float32's 24 bits), so the sums keep float32 accuracy
//   (2e-5 against the plain version). A CUDA-core version of these
//   products issued several times the instructions at G = 8 and lost to
//   SDPA at kimi-k2's heads; each warp owning its slots for both
//   products (P in registers, one barrier a tile) held more registers and
//   was slower than this split of the work.
// - float32 cache, `decode_attn_simt`, 8 warps on CUDA cores: lane j takes
//   slot j and warp w every eighth 16-byte chunk of the K row, the warps'
//   partial dot products meet in shared memory (no shuffle per slot); warp
//   g takes head g's softmax; for P . V a thread owns one 16-byte chunk of
//   the output columns for all G heads and a set of the tile's slots.
// - d only has to be a multiple of 16 (16 ... 256): d 112 is 14 chunks of
//   8 bf16, 7 k-steps of the mma.
// - The split count comes from the resident blocks an SM takes
//   (`decode_attn_plan`: cudaOccupancyMaxActiveBlocksPerMultiprocessor with
//   the pass's dynamic shared memory); the wrapper cuts the prefix into
//   chunks of whole tiles so that B * Hkv * n_split blocks fit one wave
//   (at most MAX_SPLITS splits). With one split the block writes the
//   normalised answer; else each block writes its (m, l, acc) and the last
//   of a (sequence, KV head) to finish merges them (the logsumexp merge,
//   `merge_if_last`): one launch, no combine kernel.
//
// The TPU grid walks the slots in order with the state in VMEM; the order
// of the sums differs here, which changes the last bits only (float32
// against the plain version: 2e-5). Any S, any 1 <= length <= S, G from 1
// to 8, q and out float32 or bf16, the cache float32 or bf16. Instances:
// `decode_attn_mma` for bf16 and float32 queries, `decode_attn_simt` for G
// buckets 2, 4, 8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TK = 32;                 // slots a tile
constexpr int MAX_D = 256;
constexpr int MAX_DEVICES = 64;
constexpr int MAX_SPLITS = 256;        // splits of one (sequence, KV head)
constexpr int WARPS = 8;               // the float32-cache pass
constexpr int THREADS = WARPS * 32;
constexpr int MWARPS = 4;              // the bf16-cache (mma) pass
constexpr int MTHREADS = MWARPS * 32;
constexpr int QST = 8;                 // pad of a bf16 q row (elements)
constexpr int PST = TK + 8;            // a bf16 p row (elements, padded)

// A 16-byte chunk of a float32 row as its four floats.
__device__ __forceinline__ void unpack4(const uint4& w, float* o) {
    o[0] = __uint_as_float(w.x); o[1] = __uint_as_float(w.y);
    o[2] = __uint_as_float(w.z); o[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// The same copy with no source bytes: 16 zero bytes (a partial tile's
// tail rows of V, so that 0 * garbage never reaches the mma sums).
__device__ __forceinline__ void cp_async16_zero(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, 0;\n"
                 :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float load_any(const void* p, long long i,
                                          int is_bf16) {
    return is_bf16
        ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
        : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_any(void* p, long long i, float x,
                                          int is_bf16) {
    if (is_bf16)
        reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(x);
    else
        reinterpret_cast<float*>(p)[i] = x;
}

// Shared-memory plan, the same on the host and in the kernels.
__host__ __device__ inline int chunks(int d, int elt) { return d * elt / 16; }
__host__ __device__ inline int row_chunks(int d, int elt) {
    return chunks(d, elt) | 1;                    // odd: conflict-free
}
__host__ __device__ inline int tile_bytes(int d, int elt) {
    return TK * row_chunks(d, elt) * 16;
}
inline int stages_for(int d, int elt) {
    return 4 * 2 * tile_bytes(d, elt) <= 80 * 1024 ? 4 : 3;
}
inline size_t ring_bytes(int d, int elt) {
    return (size_t)stages_for(d, elt) * 2 * tile_bytes(d, elt);
}
// float32 cache: queries (GMAX, d) float32, then the ring, which the end
// reuses for the slot sets' partial sums
inline size_t simt_smem(int d, int gmax) {
    const size_t merge = (size_t)(THREADS / chunks(d, 4)) * gmax * d * 4;
    const size_t ring = ring_bytes(d, 4);
    return (size_t)gmax * d * 4 + (ring > merge ? ring : merge);
}
// bf16 cache: TQ bf16 terms of the queries (8, d + QST), TP terms of the
// tile's probabilities (8, PST), then the ring
__host__ __device__ inline size_t mma_q_bytes(int d, int tq) {
    return (size_t)tq * 8 * (d + QST) * 2;
}
constexpr size_t MMA_P_BYTES = 3 * 8 * PST * 2;
inline size_t mma_smem(int d, int tq) {
    return mma_q_bytes(d, tq) + MMA_P_BYTES + ring_bytes(d, 2);
}

// The splits of one (sequence, KV head) meet in the block that finishes
// last: each block publishes its (m, l, acc) partials, counts itself in,
// and the last one takes the logsumexp merge for the G heads and resets
// the count for the next launch. No second kernel. `scratch` (shared, at
// least 8 * MAX_SPLITS floats) holds each head's split weights
// exp(m_s - M) / L, one warp a head (an empty split has l = 0, weight 0).
template <int NT>
__device__ __forceinline__ void merge_if_last(
        unsigned* counter, const float* part_m, const float* part_l,
        const float* part_acc, void* out, int out_bf16, long long bh0, int G,
        int d, int n_split, float* scratch) {
    __shared__ bool last;
    __threadfence();                 // this block's partials, device-wide
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == n_split - 1u;
    __syncthreads();
    if (!last) return;
    __threadfence();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int h = warp; h < G; h += NT / 32) {
        const float* pm = part_m + (bh0 + h) * n_split;
        const float* pl = part_l + (bh0 + h) * n_split;
        float M = -INFINITY;
        for (int s = lane; s < n_split; s += 32)
            if (__ldcg(pl + s) > 0.f) M = fmaxf(M, __ldcg(pm + s));
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
        float L = 0.f;
        for (int s = lane; s < n_split; s += 32) {
            const float l = __ldcg(pl + s);
            const float w = l > 0.f ? expf(__ldcg(pm + s) - M) : 0.f;
            scratch[h * n_split + s] = w;
            L = fmaf(w, l, L);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            L += __shfl_xor_sync(0xffffffffu, L, o);
        for (int s = lane; s < n_split; s += 32)
            scratch[h * n_split + s] /= L;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * d; i += NT) {
        const int h = i / d, e = i - h * d;
        const long long bh = bh0 + h;
        const float* w = scratch + h * n_split;
        const float* acc = part_acc + bh * n_split * d + e;
        float A = 0.f;
        for (int s = 0; s < n_split; ++s)
            A = fmaf(w[s], __ldcg(acc + (long long)s * d), A);
        store_any(out, bh * d + e, A, out_bf16);
    }
    if (threadIdx.x == 0) *counter = 0u;
}

template <int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_attn_simt(const void* __restrict__ q, int q_bf16,
                 const float* __restrict__ k, const float* __restrict__ v,
                 void* __restrict__ out, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc,
                 unsigned* __restrict__ counters, int S, int H, int Hkv,
                 int d, int length, int chunk, int n_split, int stages,
                 float scale, float softcap) {
    constexpr int EPC = 4;                         // floats a chunk
    static_assert(GMAX <= WARPS, "one softmax head a warp");
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float sp[WARPS][GMAX][TK];   // partial scores, one per warp
    __shared__ __align__(16) float ps[TK][GMAX];  // the tile's probabilities
    __shared__ float alpha_s[GMAX];         // the tile's rescale per head
    __shared__ float ml_s[2][GMAX];         // final m and l per head

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int G = H / Hkv, h0 = kvh * G;
    const int NC = chunks(d, 4);
    const int RS = row_chunks(d, 4);
    const int TB = tile_bytes(d, 4);
    float* qs = reinterpret_cast<float*>(smem);   // (GMAX, d) float32
    unsigned char* ring = smem + (size_t)GMAX * d * sizeof(float);

    for (int i = tid; i < G * d; i += THREADS)    // the G heads are adjacent
        qs[i] = load_any(q, ((long long)b * H + h0) * d + i, q_bf16);

    const int start = split * chunk;
    const int end = min(start + chunk, length);
    const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;
    const long long row = (long long)Hkv * d;          // one slot, all heads
    const long long off = (long long)b * S * row + (long long)kvh * d;
    const float* kb = k + off;
    const float* vb = v + off;

    // one commit group per tile index, empty past the last tile, so the
    // wait below always counts the same; thread tid copies chunks tid,
    // tid + THREADS, ... of the tile's rows (no division in the loop)
    const int j0 = tid / NC, c0 = tid - j0 * NC;
    const int dj = THREADS / NC, dc = THREADS - dj * NC;
    auto issue = [&](int t) {
        if (t < n_tiles) {
            const int base = start + t * TK;
            const int nv = min(TK, end - base);
            unsigned char* kd = ring + (size_t)(t % stages) * 2 * TB;
            unsigned char* vd = kd + TB;
            for (int j = j0, c = c0; j < nv;) {
                const long long src = (long long)(base + j) * row + c * EPC;
                cp_async16(kd + (j * RS + c) * 16, kb + src);
                cp_async16(vd + (j * RS + c) * 16, vb + src);
                j += dj;
                c += dc;
                if (c >= NC) { c -= NC; ++j; }
            }
        }
        cp_async_commit();
    };

    float m_r = -INFINITY, l_r = 0.f;    // warp g's head g (lane-replicated)
    const int nsg = THREADS / NC;        // slot sets of the P.V step
    const int pv_c = tid % NC, pv_sg = tid / NC;
    const bool pv_on = pv_sg < nsg;
    float acc[GMAX][EPC];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][e] = 0.f;

    for (int t = 0; t < stages - 1; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
        // tile t has landed once at most stages - 2 younger groups remain
        if (stages >= 4) cp_async_wait<2>(); else cp_async_wait<1>();
        __syncthreads();
        issue(t + stages - 1);           // into the stage tile t - 1 used
        const unsigned char* kt = ring + (size_t)(t % stages) * 2 * TB;
        const unsigned char* vt = kt + TB;
        const int nv = min(TK, end - (start + t * TK));

        // 1. partial scores: lane = slot, warp w = chunks w, w + WARPS, ...
        {
            float dot[GMAX];
#pragma unroll
            for (int g = 0; g < GMAX; ++g) dot[g] = 0.f;
            for (int c = warp; c < NC; c += WARPS) {
                float kf[EPC];
                unpack4(*reinterpret_cast<const uint4*>(
                    kt + (lane * RS + c) * 16), kf);
#pragma unroll
                for (int g = 0; g < GMAX; ++g) {
                    if (g < G) {
                        const float4* qp = reinterpret_cast<const float4*>(
                            qs + g * d + c * EPC);
#pragma unroll
                        for (int e = 0; e < EPC / 4; ++e) {
                            const float4 qq = qp[e];
                            float a = dot[g];
                            a = fmaf(qq.x, kf[4 * e], a);
                            a = fmaf(qq.y, kf[4 * e + 1], a);
                            a = fmaf(qq.z, kf[4 * e + 2], a);
                            a = fmaf(qq.w, kf[4 * e + 3], a);
                            dot[g] = a;
                        }
                    }
                }
            }
#pragma unroll
            for (int g = 0; g < GMAX; ++g) sp[warp][g][lane] = dot[g];
        }
        __syncthreads();

        // 2. the tile's softmax: warp g takes head g, lane = slot
        if (warp < G) {
            const int g = warp;
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) s += sp[w][g][lane];
            s *= scale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s = lane < nv ? s : -INFINITY;        // slot 0 is always valid
            float mx = s;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m_r, mx);
            const float p = expf(s - m_new);       // exp(-inf) = 0
            float sum = p;
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                sum += __shfl_xor_sync(0xffffffffu, sum, o);
            const float a = expf(m_r - m_new);
            l_r = l_r * a + sum;
            m_r = m_new;
            ps[lane][g] = p;
            if (lane == 0) alpha_s[g] = a;
        }
        __syncthreads();

        // 3. P.V: chunk pv_c of the output columns, slots pv_sg + k * nsg
        if (pv_on) {
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
                if (g < G) {
                    const float a = alpha_s[g];
#pragma unroll
                    for (int e = 0; e < EPC; ++e) acc[g][e] *= a;
                }
            }
            for (int j = pv_sg; j < nv; j += nsg) {
                float vf[EPC];
                unpack4(*reinterpret_cast<const uint4*>(
                    vt + (j * RS + pv_c) * 16), vf);
                float pj[GMAX];
#pragma unroll
                for (int g = 0; g < GMAX; g += 2) {
                    const float2 t2 = *reinterpret_cast<const float2*>(
                        &ps[j][g]);
                    pj[g] = t2.x;
                    pj[g + 1] = t2.y;
                }
#pragma unroll
                for (int g = 0; g < GMAX; ++g) {
                    if (g < G) {
                        const float p = pj[g];
#pragma unroll
                        for (int e = 0; e < EPC; ++e)
                            acc[g][e] = fmaf(p, vf[e], acc[g][e]);
                    }
                }
            }
        }
    }

    // the slot sets' partial sums meet in the ring's memory; an empty
    // split (no tile) leaves m = -inf, l = 0, which the combine skips
    cp_async_wait<0>();
    __syncthreads();
    if (warp < G && lane == 0) { ml_s[0][warp] = m_r; ml_s[1][warp] = l_r; }
    float* mb = reinterpret_cast<float*>(ring);    // (nsg, GMAX, d)
    if (pv_on) {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            if (g < G) {
#pragma unroll
                for (int e = 0; e < EPC; ++e)
                    mb[(pv_sg * GMAX + g) * d + pv_c * EPC + e] = acc[g][e];
            }
        }
    }
    __syncthreads();
    for (int i = tid; i < G * d; i += THREADS) {
        const int g = i / d, e = i - g * d;
        float A = 0.f;
        for (int sg = 0; sg < nsg; ++sg) A += mb[(sg * GMAX + g) * d + e];
        const long long bh = (long long)b * H + h0 + g;
        if (n_split == 1) {
            store_any(out, bh * d + e, A / ml_s[1][g], q_bf16);
        } else {
            part_acc[(bh * n_split + split) * d + e] = A;
            if (e == 0) {
                part_m[bh * n_split + split] = ml_s[0][g];
                part_l[bh * n_split + split] = ml_s[1][g];
            }
        }
    }
    if (n_split > 1)
        merge_if_last<THREADS>(counters + (long long)b * Hkv + kvh, part_m,
                               part_l, part_acc, out, q_bf16,
                               (long long)b * H + h0, G, d, n_split,
                               reinterpret_cast<float*>(ring));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 8x8 bf16 matrices from shared memory (rows given by lanes 0-15).
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1) : "r"(addr));
}

// Four transposed 8x8 bf16 matrices (rows given by lanes 0-31).
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// c += A . B for one m16n8k16 tile, bf16 in, float32 sums; A's rows 8-15
// (a1, a3) are zero: the G <= 8 query heads fill rows 0-7.
__device__ __forceinline__ void mma_rows8(float* c, uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// x as T bf16 terms whose float32 sum is x to 8 * T bits (T = 3: exact to
// float32's 24 bits; the products with a bf16 cache are exact in the mma).
template <int T>
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* t) {
#pragma unroll
    for (int i = 0; i < T; ++i) {
        t[i] = __float2bfloat16_rn(x);
        x -= __bfloat162float(t[i]);
    }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo)
           | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The bf16-cache pass: the same ring and split as the float32 pass, the
// products on the tensor cores. TQ: bf16 terms of q (1 for bf16 queries, 3
// for float32); TP: terms of the probabilities (2, or 3 with float32
// queries), so that both products keep float32 accuracy.
template <int TQ>
__global__ void __launch_bounds__(MTHREADS)
decode_attn_mma(const void* __restrict__ q, int q_bf16,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, void* __restrict__ out,
                float* __restrict__ part_m, float* __restrict__ part_l,
                float* __restrict__ part_acc, unsigned* __restrict__ counters,
                int S, int H, int Hkv, int d, int length, int chunk,
                int n_split, int stages, float scale, float softcap) {
    constexpr int TP = TQ == 1 ? 2 : 3;
    constexpr int NTW = MAX_D / 8 / MWARPS;     // output n-tiles a warp
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_max[MWARPS][8], red_sum[MWARPS][8];

    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;      // fragment row, column pair
    const int G = H / Hkv, h0 = kvh * G;
    const int NC = chunks(d, 2);                 // 16-byte chunks of a row
    const int RS = row_chunks(d, 2);
    const int TB = tile_bytes(d, 2);
    const int qst = d + QST;
    __nv_bfloat16* qsm = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* psm = reinterpret_cast<__nv_bfloat16*>(
        smem + mma_q_bytes(d, TQ));
    unsigned char* ring = smem + mma_q_bytes(d, TQ) + MMA_P_BYTES;

    // the queries' bf16 terms, rows G..7 zero
    for (int i = tid; i < 8 * d; i += MTHREADS) {
        const int r = i / d, e = i - r * d;
        const float x = r < G ? load_any(q, ((long long)b * H + h0 + r) * d
                                                + e, q_bf16)
                              : 0.f;
        __nv_bfloat16 parts[TQ];
        split_bf16<TQ>(x, parts);
#pragma unroll
        for (int u = 0; u < TQ; ++u) qsm[(u * 8 + r) * qst + e] = parts[u];
    }

    const int start = split * chunk;
    const int end = min(start + chunk, length);
    const int n_tiles = end > start ? (end - start + TK - 1) / TK : 0;
    const long long row = (long long)Hkv * d;
    const long long off = (long long)b * S * row + (long long)kvh * d;
    const __nv_bfloat16* kb = k + off;
    const __nv_bfloat16* vb = v + off;

    const int j0 = tid / NC, c0 = tid - j0 * NC;
    const int dj = MTHREADS / NC, dc = MTHREADS - dj * NC;
    auto issue = [&](int t) {
        if (t < n_tiles) {
            const int base = start + t * TK;
            const int nv = min(TK, end - base);
            unsigned char* kd = ring + (size_t)(t % stages) * 2 * TB;
            unsigned char* vd = kd + TB;
            for (int j = j0, c = c0; j < TK;) {
                const int at = (j * RS + c) * 16;
                if (j < nv) {
                    const long long src = (long long)(base + j) * row + c * 8;
                    cp_async16(kd + at, kb + src);
                    cp_async16(vd + at, vb + src);
                } else {
                    cp_async16_zero(vd + at, vb);
                }
                j += dj;
                c += dc;
                if (c >= NC) { c -= NC; ++j; }
            }
        }
        cp_async_commit();
    };

    float m_run = -INFINITY, l_run = 0.f;       // head g (all lanes alike)
    float acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const int n_ktiles = d / 16;
    const int NT = d / 8;

    for (int t = 0; t < stages - 1; ++t) issue(t);
    for (int t = 0; t < n_tiles; ++t) {
        if (stages >= 4) cp_async_wait<2>(); else cp_async_wait<1>();
        __syncthreads();
        issue(t + stages - 1);
        const unsigned char* kt = ring + (size_t)(t % stages) * 2 * TB;
        const unsigned char* vt = kt + TB;
        const int nv = min(TK, end - (start + t * TK));

        // 1. scores S (heads x slots) = Q . K^T: warp w takes slots 8w ..
        //    8w + 7; K rows are the col-major B operand as they lie
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        {
            const uint32_t kaddr = smem_u32(kt)
                + ((warp * 8 + (lane & 7)) * RS + ((lane >> 3) & 1)) * 16;
            for (int ks = 0; ks < n_ktiles; ++ks) {
                uint32_t b0, b1;
                ldsm_x2(kaddr + ks * 32, b0, b1);
#pragma unroll
                for (int u = 0; u < TQ; ++u) {
                    const __nv_bfloat16* qr = qsm + (u * 8 + g) * qst
                                              + ks * 16 + 2 * t4;
                    mma_rows8(sc, *reinterpret_cast<const uint32_t*>(qr),
                              *reinterpret_cast<const uint32_t*>(qr + 8),
                              b0, b1);
                }
            }
        }

        // 2. the tile's softmax: this lane holds head g at slots sl, sl + 1
        const int sl = warp * 8 + 2 * t4;
        float s0 = sc[0] * scale, s1 = sc[1] * scale;
        if (softcap > 0.f) {
            s0 = softcap * tanhf(s0 / softcap);
            s1 = softcap * tanhf(s1 / softcap);
        }
        s0 = sl < nv ? s0 : -INFINITY;          // slot 0 is always valid
        s1 = sl + 1 < nv ? s1 : -INFINITY;
        float mx = fmaxf(s0, s1);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (t4 == 0) red_max[warp][g] = mx;
        __syncthreads();
        float m_new = m_run;
#pragma unroll
        for (int w = 0; w < MWARPS; ++w) m_new = fmaxf(m_new, red_max[w][g]);
        const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
        float sum = p0 + p1;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (t4 == 0) red_sum[warp][g] = sum;
        {
            __nv_bfloat16 e0[TP], e1[TP];
            split_bf16<TP>(p0, e0);
            split_bf16<TP>(p1, e1);
#pragma unroll
            for (int u = 0; u < TP; ++u)
                *reinterpret_cast<uint32_t*>(psm + (u * 8 + g) * PST + sl) =
                    pack2(e0[u], e1[u]);
        }
        const float alpha = expf(m_run - m_new);
        m_run = m_new;
        __syncthreads();
        float tile_sum = 0.f;
#pragma unroll
        for (int w = 0; w < MWARPS; ++w) tile_sum += red_sum[w][g];
        l_run = l_run * alpha + tile_sum;
        if (alpha != 1.f) {
#pragma unroll
            for (int j = 0; j < NTW; ++j) { acc[j][0] *= alpha; acc[j][1] *= alpha; }
        }

        // 3. O (heads x d) += P . V: warp w takes the output n-tiles w,
        //    w + 4, ...; V rows are the row-major B operand, transposed by
        //    ldmatrix
        uint32_t pa[2][TP][2];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
            for (int u = 0; u < TP; ++u) {
                const __nv_bfloat16* pr = psm + (u * 8 + g) * PST + ks * 16
                                          + 2 * t4;
                pa[ks][u][0] = *reinterpret_cast<const uint32_t*>(pr);
                pa[ks][u][1] = *reinterpret_cast<const uint32_t*>(pr + 8);
            }
        const uint32_t vaddr = smem_u32(vt) + lane * RS * 16;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
            const int nt = warp + j * MWARPS;
            if (nt < NT) {
                uint32_t v0, v1, v2, v3;
                ldsm_x4_t(vaddr + nt * 16, v0, v1, v2, v3);
#pragma unroll
                for (int u = 0; u < TP; ++u) {
                    mma_rows8(acc[j], pa[0][u][0], pa[0][u][1], v0, v1);
                    mma_rows8(acc[j], pa[1][u][0], pa[1][u][1], v2, v3);
                }
            }
        }
    }
    cp_async_wait<0>();

    // this lane holds head g at d-columns 8 nt + 2 t4, + 1
    if (g < G) {
        const long long bh = (long long)b * H + h0 + g;
#pragma unroll
        for (int j = 0; j < NTW; ++j) {
            const int nt = warp + j * MWARPS;
            if (nt < NT) {
                const int e = nt * 8 + 2 * t4;
                if (n_split == 1) {
                    store_any(out, bh * d + e, acc[j][0] / l_run, q_bf16);
                    store_any(out, bh * d + e + 1, acc[j][1] / l_run, q_bf16);
                } else {
                    float* pa_out = part_acc + (bh * n_split + split) * d + e;
                    pa_out[0] = acc[j][0];
                    pa_out[1] = acc[j][1];
                }
            }
        }
        if (n_split > 1 && warp == 0 && t4 == 0) {
            part_m[bh * n_split + split] = m_run;
            part_l[bh * n_split + split] = l_run;
        }
    }
    if (n_split > 1)
        merge_if_last<MTHREADS>(counters + (long long)b * Hkv + kvh, part_m,
                                part_l, part_acc, out, q_bf16,
                                (long long)b * H + h0, G, d, n_split,
                                reinterpret_cast<float*>(ring));
}

// Raise a kernel's dynamic shared-memory limit to its largest need (d 256)
// once per device; above 48 KB a launch is refused without it.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t max_smem, bool* done) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)max_smem);
    if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
    return err;
}

// The pass for (cache type, query type, G): the kernel, its block, its
// shared memory at d and its stages.
struct Pass {
    const void* kernel;
    int threads;
    size_t smem;
    int stages;
    cudaError_t err;
};

template <int GMAX>
Pass simt_pass(int d) {
    static bool done[MAX_DEVICES] = {};
    return {reinterpret_cast<const void*>(decode_attn_simt<GMAX>), THREADS,
            simt_smem(d, GMAX), stages_for(d, 4),
            prepare(decode_attn_simt<GMAX>, simt_smem(MAX_D, GMAX), done)};
}

template <int TQ>
Pass mma_pass(int d) {
    static bool done[MAX_DEVICES] = {};
    return {reinterpret_cast<const void*>(decode_attn_mma<TQ>), MTHREADS,
            mma_smem(d, TQ), stages_for(d, 2),
            prepare(decode_attn_mma<TQ>, mma_smem(MAX_D, TQ), done)};
}

Pass pass_for(int q_bf16, int kv_bf16, int d, int G) {
    if (kv_bf16) return q_bf16 ? mma_pass<1>(d) : mma_pass<3>(d);
    if (G <= 2) return simt_pass<2>(d);
    if (G <= 4) return simt_pass<4>(d);
    return simt_pass<8>(d);
}

bool head_dim_ok(int d) { return d >= 16 && d <= MAX_D && d % 16 == 0; }

}  // namespace

// Resident blocks an SM takes of the pass for (query type, cache type, d,
// G): the wrapper sizes the grid to whole waves with it.
extern "C" int decode_attn_plan(int q_bf16, int kv_bf16, int d, int G,
                                int* blocks_per_sm) {
    if (!head_dim_ok(d) || G < 1 || G > 8) return (int)cudaErrorInvalidValue;
    const Pass p = pass_for(q_bf16, kv_bf16, d, G);
    if (p.err != cudaSuccess) return (int)p.err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, p.kernel, p.threads, p.smem);
}

// q (B, H, d) and out (B, H, d) float32 or bf16 (q_bf16); k, v (B, S, Hkv,
// d) float32 or bf16 (kv_bf16), contiguous, 16-byte aligned; d a multiple
// of 16 up to 256. Split s takes slots [s * chunk, min((s + 1) * chunk,
// length)), chunk a multiple of 32 and n_split = ceil(length / chunk).
// With n_split > 1, part_m / part_l (B * H * n_split) and part_acc (B * H
// * n_split * d) are float32 scratch and counters (B * Hkv) zeros, which
// the launch leaves zero; with one split none of them is touched.
extern "C" int decode_attn(const void* q, int q_bf16, const void* k,
                           const void* v, int kv_bf16, void* out,
                           float* part_m, float* part_l, float* part_acc,
                           unsigned* counters, int B, int S, int H, int Hkv,
                           int d, int length, int n_split, int chunk,
                           float scale, float softcap, void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (Hkv <= 0 || H % Hkv || H / Hkv > 8 || !head_dim_ok(d) ||
        length < 1 || length > S || n_split < 1 || chunk < 1 ||
        chunk % TK || (long long)n_split * chunk < length ||
        (long long)(n_split - 1) * chunk >= length || n_split > MAX_SPLITS ||
        (n_split > 1 && !(part_m && part_l && part_acc && counters)))
        return (int)cudaErrorInvalidValue;
    const int G = H / Hkv;
    const Pass p = pass_for(q_bf16, kv_bf16, d, G);
    if (p.err != cudaSuccess) return (int)p.err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(n_split, Hkv, B);
    if (kv_bf16) {
        const auto* kk = static_cast<const __nv_bfloat16*>(k);
        const auto* vv = static_cast<const __nv_bfloat16*>(v);
        if (q_bf16)
            decode_attn_mma<1><<<grid, p.threads, p.smem, s>>>(
                q, q_bf16, kk, vv, out, part_m, part_l, part_acc, counters, S,
                H, Hkv, d, length, chunk, n_split, p.stages, scale, softcap);
        else
            decode_attn_mma<3><<<grid, p.threads, p.smem, s>>>(
                q, q_bf16, kk, vv, out, part_m, part_l, part_acc, counters, S,
                H, Hkv, d, length, chunk, n_split, p.stages, scale, softcap);
    } else {
        const auto* kk = static_cast<const float*>(k);
        const auto* vv = static_cast<const float*>(v);
        if (G <= 2)
            decode_attn_simt<2><<<grid, p.threads, p.smem, s>>>(
                q, q_bf16, kk, vv, out, part_m, part_l, part_acc, counters, S,
                H, Hkv, d, length, chunk, n_split, p.stages, scale, softcap);
        else if (G <= 4)
            decode_attn_simt<4><<<grid, p.threads, p.smem, s>>>(
                q, q_bf16, kk, vv, out, part_m, part_l, part_acc, counters, S,
                H, Hkv, d, length, chunk, n_split, p.stages, scale, softcap);
        else
            decode_attn_simt<8><<<grid, p.threads, p.smem, s>>>(
                q, q_bf16, kk, vv, out, part_m, part_l, part_acc, counters, S,
                H, Hkv, d, length, chunk, n_split, p.stages, scale, softcap);
    }
    return (int)cudaGetLastError();
}
