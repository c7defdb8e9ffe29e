// AdamW's update over a table of leaves: each leaf's m, v, float32 master
// and parameter in one pass, every leaf of a launch in one grid.
//
// Replaces no TPU kernel: the JAX package's update (`repro/optim/adamw.py`)
// is plain `jnp` that XLA fuses. The port's plain version
// (`kernels/adamw/ops.py::adamw_update_ref`) runs about 20 elementwise
// launches a leaf, each writing a float32 temporary that the next reads back:
// about 188 bytes of traffic a parameter.
//
// What bounds it on an H100: bytes. One pass reads the gradient, m, v and
// the master and writes m, v, the master and the parameter: 28 bytes a bf16
// parameter, 32 a float32 one (without a master the parameter is read in the
// master's place and no master is written: 22 bytes bf16, 28 float32). At
// 3.35 TB/s that is 18.5 ms for falcon-mamba-7b's 16-layer training model
// (2.2 B parameters, 62.1 GB). The arithmetic, 16 float32 operations an
// element, is far below the card's float32 rate.
//
// What the design does about it: each byte is read and written once, and no
// temporary reaches device memory. The leaves' pointers and element counts
// travel by value in the launch's parameters (`__grid_constant__`, under
// the 4 KB that every toolkit takes: MAX_LEAVES a launch), so a step builds
// its table on the host and copies nothing to the device first. The grid
// covers every SM at the occupancy API's blocks an SM and strides over the
// chunks of all leaves in order; a block walks the table forward to the
// chunk's leaf. Loads and stores are 16 bytes a thread (8 elements: one
// vector of bf16, two of float32) where all of a leaf's pointers are 16-byte
// aligned; a leaf's ragged tail, and a leaf that is not aligned, go one
// element a thread. Streaming cache hints, since nothing is read twice.
//
// The arithmetic is the plain version's, in float32 and in its order, bit
// for bit: every operation rounds once (`__fmul_rn` and friends keep the
// compiler from contracting a product and a sum into an FMA), division and
// square root are IEEE, the constants arrive as the float32 values PyTorch
// makes of the Python floats, and the bias corrections are read from the
// 0-d device tensors the caller computed with PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;                    // elements a thread a chunk
constexpr int CHUNK = THREADS * VEC;      // elements a block a step
constexpr int MAX_LEAVES = 80;            // kernels/adamw/ops.py::MAX_LEAVES

struct Leaf {                             // 48 bytes
    void* p;                              // the parameter, bf16 or float32
    const void* g;                        // its gradient, the same type
    float* m;
    float* v;
    float* w;                             // the float32 master, or null
    long long n;
};

struct LeafTable {                        // travels in the launch's parameters
    Leaf at[MAX_LEAVES];
};

struct Hyper {
    float b1, c1, b2, c2;                 // b1, 1 - b1, b2, 1 - b2
    float eps, wd, lr;
    const float* bc1;                     // 1 - b1 ** t, a 0-d device tensor
    const float* bc2;
};

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__host__ __device__ __forceinline__ long long chunks_of(long long n) {
    return (n + CHUNK - 1) / CHUNK;
}

// The plain version's update of one element, operation for operation.
__device__ __forceinline__ void adamw_step(float g, float& m, float& v,
                                           float& w, const Hyper& h,
                                           float bc1, float bc2) {
    m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
    v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
    const float u = __fadd_rn(__fdiv_rn(__fdiv_rn(m, bc1), den),
                              __fmul_rn(h.wd, w));
    w = __fsub_rn(w, __fmul_rn(h.lr, u));
}

__device__ __forceinline__ float load1(const float* src) { return *src; }
__device__ __forceinline__ float load1(const __nv_bfloat16* src) {
    return __bfloat162float(*src);
}
__device__ __forceinline__ void store1(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load8(const float* src, float (&x)[VEC]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(src));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(src) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src,
                                      float (&x)[VEC]) {
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(src));
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {         // a bf16 is a float's top half
        x[2 * k] = __uint_as_float(u[k] << 16);
        x[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
}
__device__ __forceinline__ void store8(float* dst, const float (&x)[VEC]) {
    __stcs(reinterpret_cast<float4*>(dst), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(dst) + 1,
           make_float4(x[4], x[5], x[6], x[7]));
}
__device__ __forceinline__ void store8(__nv_bfloat16* dst,
                                       const float (&x)[VEC]) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        u[k] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k])) |
               ((uint32_t)__bfloat16_as_ushort(
                    __float2bfloat16_rn(x[2 * k + 1])) << 16);
    __stcs(reinterpret_cast<uint4*>(dst), make_uint4(u[0], u[1], u[2], u[3]));
}

// Without a master the parameter itself, in float32, is the weight.
template <typename P, bool MASTER>
__global__ void __launch_bounds__(THREADS)
adamw_kernel(const __grid_constant__ LeafTable tab, int n_leaves,
             const Hyper h) {
    const float bc1 = __ldg(h.bc1), bc2 = __ldg(h.bc2);
    int leaf = 0;
    long long first = 0;                  // the leaf's first chunk
    long long count = chunks_of(tab.at[0].n);
    for (long long c = blockIdx.x;; c += gridDim.x) {
        while (c >= first + count) {      // chunks rise: walk forward
            if (++leaf == n_leaves) return;
            first += count;
            count = chunks_of(tab.at[leaf].n);
        }
        const Leaf& L = tab.at[leaf];
        const long long base = (c - first) * CHUNK;
        const long long left = L.n - base;
        const int len = left < CHUNK ? (int)left : CHUNK;
        P* __restrict__ p = static_cast<P*>(L.p) + base;
        const P* __restrict__ g = static_cast<const P*>(L.g) + base;
        float* __restrict__ m = L.m + base;
        float* __restrict__ v = L.v + base;
        float* __restrict__ w = MASTER ? L.w + base : nullptr;
        int done = 0;
        if (aligned16(L.p) && aligned16(L.g) && aligned16(L.m) &&
            aligned16(L.v) && (!MASTER || aligned16(L.w))) {
            const int nv = len / VEC;
            for (int i = threadIdx.x; i < nv; i += THREADS) {
                const int o = i * VEC;
                float gx[VEC], mx[VEC], vx[VEC], wx[VEC];
                load8(g + o, gx);
                load8(m + o, mx);
                load8(v + o, vx);
                if constexpr (MASTER) load8(w + o, wx);
                else load8(p + o, wx);
#pragma unroll
                for (int k = 0; k < VEC; ++k)
                    adamw_step(gx[k], mx[k], vx[k], wx[k], h, bc1, bc2);
                store8(m + o, mx);
                store8(v + o, vx);
                if constexpr (MASTER) store8(w + o, wx);
                store8(p + o, wx);
            }
            done = nv * VEC;
        }
        for (int i = done + threadIdx.x; i < len; i += THREADS) {
            float mi = m[i], vi = v[i];
            float wi = MASTER ? w[i] : load1(p + i);
            adamw_step(load1(g + i), mi, vi, wi, h, bc1, bc2);
            m[i] = mi;
            v[i] = vi;
            if constexpr (MASTER) w[i] = wi;
            store1(p + i, wi);
        }
    }
}

template <typename P, bool MASTER>
cudaError_t launch(const LeafTable& tab, int n_leaves, long long chunks,
                   const Hyper& h, cudaStream_t s) {
    static int per_sm = 0;                // blocks an SM, asked once
    cudaError_t err;
    if (per_sm == 0 &&
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, adamw_kernel<P, MASTER>, THREADS, 0)) != cudaSuccess)
        return err;
    int dev = 0, sms = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
    if (grid > chunks) grid = chunks;
    adamw_kernel<P, MASTER><<<(unsigned)grid, THREADS, 0, s>>>(tab, n_leaves,
                                                               h);
    return cudaGetLastError();
}

}  // namespace

// `table`: 6 int64s a leaf (parameter, gradient, m, v, master or 0, element
// count), up to MAX_LEAVES leaves of one instance: bf16 or float32
// parameters (and gradients), with or without masters. Updates in place on
// `stream`; launches nothing when the leaves hold no element.
extern "C" int adamw_update(const long long* table, int n_leaves, int bf16,
                            int master, float b1, float c1, float b2,
                            float c2, float eps, float wd, float lr,
                            const float* bc1, const float* bc2,
                            void* stream) {
    if (n_leaves < 1 || n_leaves > MAX_LEAVES || !bc1 || !bc2)
        return (int)cudaErrorInvalidValue;
    LeafTable tab = {};
    long long chunks = 0;
    for (int i = 0; i < n_leaves; ++i) {
        const long long* e = table + 6 * i;
        Leaf& L = tab.at[i];
        L.p = reinterpret_cast<void*>(e[0]);
        L.g = reinterpret_cast<const void*>(e[1]);
        L.m = reinterpret_cast<float*>(e[2]);
        L.v = reinterpret_cast<float*>(e[3]);
        L.w = reinterpret_cast<float*>(e[4]);
        L.n = e[5];
        if (L.n < 0 || (L.n > 0 && (!L.p || !L.g || !L.m || !L.v ||
                                    (master && !L.w))))
            return (int)cudaErrorInvalidValue;
        chunks += chunks_of(L.n);
    }
    if (chunks == 0) return (int)cudaSuccess;
    const Hyper h = {b1, c1, b2, c2, eps, wd, lr, bc1, bc2};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bf16)
        err = master ? launch<__nv_bfloat16, true>(tab, n_leaves, chunks, h, s)
                     : launch<__nv_bfloat16, false>(tab, n_leaves, chunks, h, s);
    else
        err = master ? launch<float, true>(tab, n_leaves, chunks, h, s)
                     : launch<float, false>(tab, n_leaves, chunks, h, s);
    return (int)err;
}
