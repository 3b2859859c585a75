// Exact per-slot int64 sums of K pre-masked vectors, keyed by dense slot ids.
//
// Replaces the Pallas kernel duckdb_tpu/ops/pallas_agg.py:_kernel (launched
// by grouped_sum_i64). That kernel splits every int64 into 8-bit limbs and
// sums them on the TPU's matrix unit because the v5e has no 64-bit
// datapath. Hopper adds int64 natively, so none of that carries over: each
// block keeps an (nseg, K) table of unsigned 64-bit sums in shared memory,
// every live row adds its K values into its slot's row of the table with
// shared-memory atomics, and the block flushes its nonzero entries to the
// (nseg, K) output with global atomics. A row of the table is K | 1 words
// long: with an even length (K = 16 is 128 bytes) every slot's row starts
// on the same shared-memory bank, and lanes adding into different slots
// conflict; the odd length spreads the slots over the banks. Unsigned
// addition wraps mod 2^64 and is associative, so the result is
// bit-identical to a sequential int64 sum whatever order the atomics land
// in.
//
// Bound on this card: memory. The kernel reads N x (4 + 8K) bytes once and
// does K adds per row, far below the card's integer rate; at 3.35 TB/s the
// bytes set the floor. Known weak spot: with few live slots (TPC-H Q1 has
// 4) the lanes of a warp collide on a handful of shared addresses and the
// atomics serialise.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

#define GS_MAX_K 24
#define GS_THREADS 256

struct VecPtrs {
    const long long* p[GS_MAX_K];
};

__global__ void __launch_bounds__(GS_THREADS)
grouped_sum_i64_kernel(const int* __restrict__ dense, VecPtrs vecs,
                       long long n, int k, int nseg,
                       unsigned long long* __restrict__ out) {
    extern __shared__ unsigned long long acc[];
    const int ks = k | 1;  // row length of the table: odd, see above
    const int cells = nseg * ks;
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0ULL;
    __syncthreads();

    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         row < n; row += stride) {
        const int s = dense[row];
        if (s < 0 || s >= nseg) continue;  // dead row: no slot
        unsigned long long* a = acc + s * ks;
        for (int j = 0; j < k; ++j) {
            atomicAdd(a + j, (unsigned long long)__ldg(vecs.p[j] + row));
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
        const int s = i / ks, j = i - s * ks;
        const unsigned long long v = acc[i];
        if (j < k && v != 0ULL) atomicAdd(out + s * k + j, v);
    }
}

// dense: (n,) int32 slot ids; vec_ptrs: k device pointers to (n,) int64;
// out: zeroed (nseg, k) int64. Returns cudaGetLastError() after the launch.
extern "C" int grouped_sum_i64(const void* dense, const void* const* vec_ptrs,
                               long long n, int k, int nseg, void* out,
                               int grid, void* stream) {
    if (k < 1 || k > GS_MAX_K || nseg < 1 || grid < 1 || n < 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)nseg * (k | 1) * sizeof(unsigned long long);
    if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    VecPtrs ptrs;
    for (int j = 0; j < GS_MAX_K; ++j)
        ptrs.p[j] = j < k ? (const long long*)vec_ptrs[j] : nullptr;
    grouped_sum_i64_kernel<<<grid, GS_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)dense, ptrs, n, k, nseg, (unsigned long long*)out);
    return (int)cudaGetLastError();
}
