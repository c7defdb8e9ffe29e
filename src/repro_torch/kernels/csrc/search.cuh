// Binary searches over an ascending run, shared by the merge kernels: every
// element of one sorted run finds its output slot as its own index plus its
// rank in the other run.
#pragma once

// number of elements of the ascending run x[0..n) that are < key
template <typename T>
__device__ __forceinline__ int lower_bound(const T* x, int n, T key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (x[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// number of elements of the ascending run x[0..n) that are <= key
template <typename T>
__device__ __forceinline__ int upper_bound(const T* x, int n, T key) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (x[mid] <= key) lo = mid + 1; else hi = mid;
    }
    return lo;
}
