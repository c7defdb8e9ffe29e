// Flash-decode attention: one query token per sequence against a KV cache.
//
// Replaces the TPU kernel `_decode_kernel` / `decode_attention_kernel`
// (kernels/decode_attn/decode_attn.py of the JAX package): for q (B, H, d)
// and a cache k, v (B, S, Hkv, d) whose first `length` slots are valid, it
// returns softmax(softcap(q . k * scale)) . v per query head, the G = H /
// Hkv query heads of a KV head sharing that head's cache (GQA), in q's
// type with float32 accumulation.
//
// What bounds it on an H100: bytes. Every valid cache slot is read once
// (2 * length * Hkv * d elements per sequence); the arithmetic is 4 * G *
// d flops per slot, far below the card's rate. So the design streams only
// the valid prefix [0, length): masked slots are never read, which gives
// the reference's answer (it masks them to -1e30 and their weight
// underflows to 0). One thread block takes one (split, KV head, sequence);
// the splits cut the prefix into `n_split` chunks so that B * Hkv * n_split
// blocks fill the card (B * Hkv is 32 for gemma2 at B = 4, far under 132
// SMs). Inside a block each warp walks its own slots, P at a time: it
// loads the P K rows and P V rows first (each lane d / 32 contiguous
// elements, 16-byte loads for bf16 at d = 256), then takes the G dot
// products with warp shuffles and updates its float32 online-softmax state
// (m, l, acc) once per P slots. The block merges its warps' states in
// shared memory; with one split it writes the normalised answer, else its
// (m, l, acc) go to scratch and `decode_attn_combine` merges the splits
// (the logsumexp merge). The TPU grid walks the slots in order with the
// state in VMEM; here the order of the sums differs, which changes the
// last bits only (float32 against the plain version: 2e-5). Any S, any
// 1 <= length <= S, d in {64, 128, 256}, G from 1 to 8; `tanhf` and
// `expf` (not the fast intrinsics) for the softcap and the softmax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ void unpack_bf16x2(uint32_t w, float* out) {
    out[0] = __uint_as_float(w << 16);            // element 0: low half
    out[1] = __uint_as_float(w & 0xffff0000u);
}

// One lane's DV contiguous elements of a row.
template <int DV>
__device__ __forceinline__ void load_lane(const float* __restrict__ p,
                                          float* out) {
    if constexpr (DV % 4 == 0) {
#pragma unroll
        for (int i = 0; i < DV; i += 4) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(p + i));
            out[i] = t.x; out[i + 1] = t.y; out[i + 2] = t.z; out[i + 3] = t.w;
        }
    } else {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        out[0] = t.x; out[1] = t.y;
    }
}

template <int DV>
__device__ __forceinline__ void load_lane(const __nv_bfloat16* __restrict__ p,
                                          float* out) {
    if constexpr (DV == 8) {
        const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
        unpack_bf16x2(t.x, out); unpack_bf16x2(t.y, out + 2);
        unpack_bf16x2(t.z, out + 4); unpack_bf16x2(t.w, out + 6);
    } else if constexpr (DV == 4) {
        const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
        unpack_bf16x2(t.x, out); unpack_bf16x2(t.y, out + 2);
    } else {
        unpack_bf16x2(__ldg(reinterpret_cast<const unsigned int*>(p)), out);
    }
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

template <typename KV, int DV, int GMAX>
__global__ void __launch_bounds__(THREADS)
decode_attn_split(const void* __restrict__ q, int q_bf16,
                  const KV* __restrict__ k, const KV* __restrict__ v,
                  void* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int S, int H, int Hkv, int G, int length, int chunk,
                  int n_split, float scale, float softcap) {
    constexpr int D = 32 * DV;
    constexpr int P = (GMAX * DV <= 16) ? 4 : 2;   // slots per warp step
    const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int h0 = kvh * G;

    float qr[GMAX][DV];
#pragma unroll
    for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int i = 0; i < DV; ++i)
            qr[g][i] = g < G ? load_any(q, ((long long)b * H + h0 + g) * D
                                               + lane * DV + i, q_bf16)
                             : 0.f;
    float m[GMAX], l[GMAX], acc[GMAX][DV];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        m[g] = -INFINITY;
        l[g] = 0.f;
#pragma unroll
        for (int i = 0; i < DV; ++i) acc[g][i] = 0.f;
    }

    const int start = split * chunk;
    const int end = min(start + chunk, length);
    const long long row = (long long)Hkv * D;          // one slot, all heads
    const long long off = (long long)b * S * row + (long long)kvh * D
                          + lane * DV;
    const KV* kb = k + off;
    const KV* vb = v + off;

    for (int base = start + warp * P; base < end; base += WARPS * P) {
        float kr[P][DV], vr[P][DV];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if (base + j < end) {
                load_lane<DV>(kb + (long long)(base + j) * row, kr[j]);
                load_lane<DV>(vb + (long long)(base + j) * row, vr[j]);
            } else {
#pragma unroll
                for (int i = 0; i < DV; ++i) kr[j][i] = vr[j][i] = 0.f;
            }
        }
        float sc[P][GMAX];
#pragma unroll
        for (int j = 0; j < P; ++j)
#pragma unroll
            for (int g = 0; g < GMAX; ++g) {
                float dot = 0.f;
#pragma unroll
                for (int i = 0; i < DV; ++i) dot = fmaf(qr[g][i], kr[j][i], dot);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    dot += __shfl_xor_sync(0xffffffffu, dot, o);
                dot *= scale;
                if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
                sc[j][g] = base + j < end ? dot : -INFINITY;
            }
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
            if (g >= G) break;
            float mx = m[g];
#pragma unroll
            for (int j = 0; j < P; ++j) mx = fmaxf(mx, sc[j][g]);
            // slot `base` is valid, so mx is finite; exp(-inf) = 0
            const float alpha = expf(m[g] - mx);
            float p[P], sum = 0.f;
#pragma unroll
            for (int j = 0; j < P; ++j) {
                p[j] = expf(sc[j][g] - mx);
                sum += p[j];
            }
            l[g] = l[g] * alpha + sum;
#pragma unroll
            for (int i = 0; i < DV; ++i) {
                float a = acc[g][i] * alpha;
#pragma unroll
                for (int j = 0; j < P; ++j) a = fmaf(p[j], vr[j][i], a);
                acc[g][i] = a;
            }
            m[g] = mx;
        }
    }

    // merge the warps' states; a warp that got no slot has l = 0
    __shared__ float sm_m[WARPS][GMAX], sm_l[WARPS][GMAX];
    __shared__ float sm_acc[WARPS][GMAX][D];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
        if (lane == 0) { sm_m[warp][g] = m[g]; sm_l[warp][g] = l[g]; }
#pragma unroll
        for (int i = 0; i < DV; ++i) sm_acc[warp][g][lane * DV + i] = acc[g][i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * D; idx += THREADS) {
        const int g = idx / D, t = idx - g * D;
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
        float L = 0.f, A = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            const float wt = sm_l[w][g] > 0.f ? expf(sm_m[w][g] - M) : 0.f;
            L = fmaf(wt, sm_l[w][g], L);
            A = fmaf(wt, sm_acc[w][g][t], A);
        }
        const long long bh = (long long)b * H + h0 + g;
        if (n_split == 1) {
            store_any(out, bh * D + t, A / L, q_bf16);
        } else {
            part_acc[(bh * n_split + split) * D + t] = A;
            if (t == 0) {
                part_m[bh * n_split + split] = M;
                part_l[bh * n_split + split] = L;
            }
        }
    }
}

// One block per (sequence, query head), one thread per element of d: the
// logsumexp merge of the splits' (m, l, acc). An empty split has l = 0.
__global__ void decode_attn_combine(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc,
                                    void* __restrict__ out, int out_bf16,
                                    int n_split, int D) {
    const long long bh = blockIdx.x;
    const int t = threadIdx.x;
    const float* pm = part_m + bh * n_split;
    const float* pl = part_l + bh * n_split;
    float M = -INFINITY;
    for (int s = 0; s < n_split; ++s)
        if (pl[s] > 0.f) M = fmaxf(M, pm[s]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_split; ++s) {
        if (!(pl[s] > 0.f)) continue;
        const float wt = expf(pm[s] - M);
        L = fmaf(wt, pl[s], L);
        A = fmaf(wt, part_acc[(bh * n_split + s) * D + t], A);
    }
    store_any(out, bh * D + t, A / L, out_bf16);
}

template <typename KV, int DV, int GMAX>
cudaError_t launch(const void* q, int q_bf16, const void* k, const void* v,
                   void* out, float* pm, float* pl, float* pa, int B, int S,
                   int H, int Hkv, int length, int n_split, float scale,
                   float softcap, cudaStream_t s) {
    const int G = H / Hkv;
    const int chunk = (length + n_split - 1) / n_split;
    const dim3 grid(n_split, Hkv, B);
    decode_attn_split<KV, DV, GMAX><<<grid, THREADS, 0, s>>>(
        q, q_bf16, static_cast<const KV*>(k), static_cast<const KV*>(v), out,
        pm, pl, pa, S, H, Hkv, G, length, chunk, n_split, scale, softcap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return err;
    decode_attn_combine<<<B * H, 32 * DV, 0, s>>>(pm, pl, pa, out, q_bf16,
                                                  n_split, 32 * DV);
    return cudaGetLastError();
}

template <typename KV, int DV>
cudaError_t by_group(int G, const void* q, int q_bf16, const void* k,
                     const void* v, void* out, float* pm, float* pl,
                     float* pa, int B, int S, int H, int Hkv, int length,
                     int n_split, float scale, float softcap, cudaStream_t s) {
    if (G <= 2)
        return launch<KV, DV, 2>(q, q_bf16, k, v, out, pm, pl, pa, B, S, H,
                                 Hkv, length, n_split, scale, softcap, s);
    if (G <= 4)
        return launch<KV, DV, 4>(q, q_bf16, k, v, out, pm, pl, pa, B, S, H,
                                 Hkv, length, n_split, scale, softcap, s);
    return launch<KV, DV, 8>(q, q_bf16, k, v, out, pm, pl, pa, B, S, H, Hkv,
                             length, n_split, scale, softcap, s);
}

template <typename KV>
cudaError_t by_dim(int d, int G, const void* q, int q_bf16, const void* k,
                   const void* v, void* out, float* pm, float* pl, float* pa,
                   int B, int S, int H, int Hkv, int length, int n_split,
                   float scale, float softcap, cudaStream_t s) {
    switch (d) {
        case 64:
            return by_group<KV, 2>(G, q, q_bf16, k, v, out, pm, pl, pa, B, S,
                                   H, Hkv, length, n_split, scale, softcap, s);
        case 128:
            return by_group<KV, 4>(G, q, q_bf16, k, v, out, pm, pl, pa, B, S,
                                   H, Hkv, length, n_split, scale, softcap, s);
        case 256:
            return by_group<KV, 8>(G, q, q_bf16, k, v, out, pm, pl, pa, B, S,
                                   H, Hkv, length, n_split, scale, softcap, s);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace

// q (B, H, d) and out (B, H, d) float32 or bf16 (q_bf16); k, v (B, S, Hkv,
// d) float32 or bf16 (kv_bf16), contiguous, 16-byte aligned. With n_split
// > 1, part_m / part_l (B * H * n_split) and part_acc (B * H * n_split * d)
// are float32 scratch; with one split they are not read.
extern "C" int decode_attn(const void* q, int q_bf16, const void* k,
                           const void* v, int kv_bf16, void* out,
                           float* part_m, float* part_l, float* part_acc,
                           int B, int S, int H, int Hkv, int d, int length,
                           int n_split, float scale, float softcap,
                           void* stream) {
    if (B <= 0 || H <= 0) return (int)cudaSuccess;
    if (Hkv <= 0 || H % Hkv || H / Hkv > 8 || length < 1 || length > S ||
        n_split < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int G = H / Hkv;
    cudaError_t err =
        kv_bf16 ? by_dim<__nv_bfloat16>(d, G, q, q_bf16, k, v, out, part_m,
                                        part_l, part_acc, B, S, H, Hkv,
                                        length, n_split, scale, softcap, s)
                : by_dim<float>(d, G, q, q_bf16, k, v, out, part_m, part_l,
                                part_acc, B, S, H, Hkv, length, n_split,
                                scale, softcap, s);
    return (int)err;
}
