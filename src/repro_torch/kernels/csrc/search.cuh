// Binary searches over an ascending run, shared by the merge kernels: every
// element of one sorted run finds its output slot as its own index plus its
// rank in the other run.
#pragma once

// The key order of every sort and merge: `<` for integers; for float32 a
// total order with NaN after every other value (as torch.sort and jnp.sort
// order it), so a NaN never stops a search or a compare-exchange.
template <typename T>
__device__ __forceinline__ bool key_lt(T a, T b) {
    return a < b;
}

template <>
__device__ __forceinline__ bool key_lt<float>(float a, float b) {
    const bool a_nan = a != a, b_nan = b != b;   // no fast-math: exact
    return !a_nan && (b_nan || a < b);
}

// number of elements of the ascending run x[0..n) that are < key
template <typename T>
__device__ __forceinline__ int lower_bound(const T* x, int n, T key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_lt(x[mid], key)) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// number of elements of the ascending run x[0..n) that are <= key
template <typename T>
__device__ __forceinline__ int upper_bound(const T* x, int n, T key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!key_lt(key, x[mid])) lo = mid + 1; else hi = mid;
    }
    return lo;
}
