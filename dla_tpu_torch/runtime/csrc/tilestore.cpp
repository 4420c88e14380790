// Native host runtime for the out-of-core path (a copy of
// dla_tpu/runtime/csrc/tilestore.cpp, plus dla_probe_x below).
//
// The reference's native runtime pieces are StarPU (pinned host buffers via
// starpu_malloc for fast DMA — v6_script_cholesky_w_residu_malloc.c:41-58)
// and the ArmoniK C++ client/worker (tile blob (de)serialization —
// client_distrib.cpp:280-309, worker_distrib.cpp:212-213). The TPU-native
// equivalent is this host tile store: page-aligned host matrix storage,
// strided tile/panel gather-scatter into contiguous staging buffers for
// device transfer, seeded SPD generation *bit-identical* to the on-device
// JAX generator (same murmur3-fmix32 pair hash, so host- and
// device-generated tiles agree exactly), infinity norms, and a Freivalds
// probabilistic residual probe (O(N²) per probe) for validating
// factorizations too large to reconstruct densely.
//
// Built at first use by dla_tpu_torch/runtime/staging.py (g++ -O3 -march=native
// -std=c++17 -fPIC -fopenmp -shared) into build/dla_tpu_torch/.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <limits>
#include <cstring>

#include <errno.h>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Aligned allocation (page-aligned, the pinned-buffer analogue)
// ---------------------------------------------------------------------------

void* dla_alloc(int64_t bytes) {
  void* p = nullptr;
  if (posix_memalign(&p, 4096, static_cast<size_t>(bytes)) != 0) return nullptr;
  return p;
}

void dla_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Direct (page-cache-bypassing) file I/O for the panel-blocked disk store.
//
// This VM's kernel inserts page-cache pages at ~0.2-0.5 ms each, capping
// buffered writes / memmap first-touch at ~18 MB/s, while O_DIRECT streams
// at ~430-570 MB/s — so the disk-backed out-of-core path does its own
// sequential I/O with O_DIRECT (4096-aligned buffers, offsets, lengths).
// Callers fall back to buffered mode when the filesystem rejects O_DIRECT.
// ---------------------------------------------------------------------------

// Returns fd >= 0, or -errno. direct=1 requests O_DIRECT.
int64_t dla_open_file(const char* path, int32_t create, int32_t direct) {
  int flags = O_RDWR | (create ? O_CREAT : 0);
#ifdef O_DIRECT
  if (direct) flags |= O_DIRECT;
#else
  if (direct) return -EINVAL;
#endif
  int fd = open(path, flags, 0644);
  if (fd < 0) return -static_cast<int64_t>(errno);
  return fd;
}

void dla_close_file(int64_t fd) { close(static_cast<int>(fd)); }

int64_t dla_fsync(int64_t fd) {
  if (fdatasync(static_cast<int>(fd)) != 0)
    return -static_cast<int64_t>(errno);
  return 0;
}

int64_t dla_truncate_file(int64_t fd, int64_t size) {
  if (ftruncate(static_cast<int>(fd), static_cast<off_t>(size)) != 0)
    return -static_cast<int64_t>(errno);
  return 0;
}

// Full pread/pwrite loops; return bytes transferred or -errno.
int64_t dla_pread_full(int64_t fd, void* buf, int64_t nbytes, int64_t off) {
  char* p = static_cast<char*>(buf);
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t r = pread(static_cast<int>(fd), p + done,
                      static_cast<size_t>(nbytes - done),
                      static_cast<off_t>(off + done));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -static_cast<int64_t>(errno);
    }
    if (r == 0) break;  // EOF
    done += r;
  }
  return done;
}

int64_t dla_pwrite_full(int64_t fd, const void* buf, int64_t nbytes,
                        int64_t off) {
  const char* p = static_cast<const char*>(buf);
  int64_t done = 0;
  while (done < nbytes) {
    ssize_t r = pwrite(static_cast<int>(fd), p + done,
                       static_cast<size_t>(nbytes - done),
                       static_cast<off_t>(off + done));
    if (r < 0) {
      if (errno == EINTR) continue;
      return -static_cast<int64_t>(errno);
    }
    if (r == 0) break;  // no forward progress — report the short write
    done += r;
  }
  return done;
}

// ---------------------------------------------------------------------------
// Seeded symmetric generation — identical to ops/lapack_like.py:_pair_uniform
// ---------------------------------------------------------------------------

static inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

static inline float pair_uniform(uint32_t seed, uint32_t i, uint32_t j) {
  const uint32_t lo = i < j ? i : j;
  const uint32_t hi = i < j ? j : i;
  uint32_t h = mix32(hi * 0x7F4A7C15u ^ seed);
  h = mix32(lo * 0x9E3779B9u ^ h);
  return static_cast<float>(h >> 8) * (1.0f / 16777216.0f) - 0.5f;
}

// Fill dst (h x w, leading dim ld) with the global seeded symmetric matrix
// region whose top-left global element is (i0, j0); bump added on the
// global diagonal.
#define DEFINE_PLGSY(SUF, T)                                                  \
  void dla_plgsy_##SUF(T* dst, int64_t ld, uint32_t seed, int64_t i0,         \
                       int64_t j0, int64_t h, int64_t w, double bump) {       \
    _Pragma("omp parallel for schedule(static)")                              \
    for (int64_t r = 0; r < h; ++r) {                                         \
      const uint32_t gi = static_cast<uint32_t>(i0 + r);                      \
      T* row = dst + r * ld;                                                  \
      for (int64_t c = 0; c < w; ++c) {                                       \
        const uint32_t gj = static_cast<uint32_t>(j0 + c);                    \
        T v = static_cast<T>(pair_uniform(seed, gi, gj));                     \
        if (gi == gj) v += static_cast<T>(bump);                              \
        row[c] = v;                                                           \
      }                                                                       \
    }                                                                         \
  }

DEFINE_PLGSY(f32, float)
DEFINE_PLGSY(f64, double)

// ---------------------------------------------------------------------------
// Strided 2D pack/unpack (tile & panel gather-scatter)
// ---------------------------------------------------------------------------

#define DEFINE_COPY2D(SUF, T)                                                 \
  void dla_copy2d_##SUF(const T* src, int64_t ld_src, T* dst, int64_t ld_dst, \
                        int64_t h, int64_t w) {                               \
    _Pragma("omp parallel for schedule(static)")                              \
    for (int64_t r = 0; r < h; ++r) {                                         \
      memcpy(dst + r * ld_dst, src + r * ld_src, sizeof(T) * w);              \
    }                                                                         \
  }

DEFINE_COPY2D(f32, float)
DEFINE_COPY2D(f64, double)

// ---------------------------------------------------------------------------
// Norms over symmetric-from-lower storage
// ---------------------------------------------------------------------------

// ||A||_inf where A is symmetric and only tril(A) (incl. diag) is stored in
// the (n x n, leading dim ld) buffer.
#define DEFINE_NORM(SUF, T)                                                   \
  double dla_norm_inf_sym_lower_##SUF(const T* a, int64_t n, int64_t ld) {    \
    double best = 0.0;                                                        \
    _Pragma("omp parallel")                                                   \
    {                                                                         \
      double local = 0.0;                                                     \
      _Pragma("omp for schedule(static)")                                     \
      for (int64_t i = 0; i < n; ++i) {                                       \
        double s = 0.0;                                                       \
        for (int64_t j = 0; j <= i; ++j) s += std::fabs((double)a[i * ld + j]); \
        for (int64_t j = i + 1; j < n; ++j) s += std::fabs((double)a[j * ld + i]); \
        if (s > local) local = s;                                             \
      }                                                                       \
      _Pragma("omp critical")                                                 \
      if (local > best) best = local;                                         \
    }                                                                         \
    return best;                                                              \
  }

DEFINE_NORM(f32, float)
DEFINE_NORM(f64, double)

// ---------------------------------------------------------------------------
// Freivalds residual probe:  max_i |(A - L L^T) x|_i  for a random probe x
// ---------------------------------------------------------------------------
// A symmetric-from-lower in `a`; L lower-triangular in `l` (same n, ld).
// Returns ||(A - L L^T) x||_inf / ||x||_inf (the probe's *actual* infinity
// norm, not its theoretical 0.5 bound); the caller normalizes by ||A||_inf.
// O(N²) per probe instead of O(N³) dense reconstruction — the out-of-core
// validation path. Returns NaN on allocation failure, and where any row of
// the residual is NaN (the JAX package's copy skips such rows, so an all-NaN
// factor reads 0 there).

static inline double probe_x(uint32_t seed, int64_t i) {
  uint32_t h = mix32(static_cast<uint32_t>(i) * 0x9E3779B9u ^ seed);
  return static_cast<double>(h >> 8) * (1.0 / 16777216.0) - 0.5;
}

// The probe vector itself, for tests that hold other generators to its bits.
void dla_probe_x(double* out, int64_t n, uint32_t seed) {
  for (int64_t i = 0; i < n; ++i) out[i] = probe_x(seed, i);
}

#define DEFINE_FREIVALDS(SUF, T)                                              \
  double dla_freivalds_##SUF(const T* a, const T* l, int64_t n, int64_t ld,   \
                             uint32_t seed) {                                 \
    double* x = (double*)malloc(sizeof(double) * n);                          \
    double* y = (double*)calloc(n, sizeof(double));  /* A x */                \
    double* t = (double*)calloc(n, sizeof(double));  /* L^T x */              \
    if (!x || !y || !t) {                                                     \
      free(x); free(y); free(t);                                              \
      return std::numeric_limits<double>::quiet_NaN();                        \
    }                                                                         \
    double xinf = 0.0;                                                        \
    for (int64_t i = 0; i < n; ++i) {                                         \
      x[i] = probe_x(seed, i);                                                \
      if (std::fabs(x[i]) > xinf) xinf = std::fabs(x[i]);                     \
    }                                                                         \
    _Pragma("omp parallel for schedule(static)")                              \
    for (int64_t i = 0; i < n; ++i) {                                         \
      double s = 0.0;                                                         \
      for (int64_t j = 0; j <= i; ++j) s += (double)a[i * ld + j] * x[j];     \
      for (int64_t j = i + 1; j < n; ++j) s += (double)a[j * ld + i] * x[j];  \
      y[i] = s;                                                               \
    }                                                                         \
    _Pragma("omp parallel for schedule(static)")                              \
    for (int64_t j = 0; j < n; ++j) {                                         \
      double s = 0.0;                                                         \
      for (int64_t i = j; i < n; ++i) s += (double)l[i * ld + j] * x[i];      \
      t[j] = s;                                                               \
    }                                                                         \
    double err = 0.0;                                                         \
    _Pragma("omp parallel")                                                   \
    {                                                                         \
      double local = 0.0;                                                     \
      _Pragma("omp for schedule(static)")                                     \
      for (int64_t i = 0; i < n; ++i) {                                       \
        double s = 0.0;                                                       \
        for (int64_t j = 0; j <= i; ++j) s += (double)l[i * ld + j] * t[j];   \
        const double d = std::fabs(y[i] - s);                                 \
        if (!(d <= local)) local = d;  /* NaN wins: a NaN factor fails */     \
      }                                                                       \
      _Pragma("omp critical")                                                 \
      if (!(local <= err)) err = local;                                       \
    }                                                                         \
    free(x); free(y); free(t);                                                \
    return err / xinf;                                                        \
  }

DEFINE_FREIVALDS(f32, float)
DEFINE_FREIVALDS(f64, double)

}  // extern "C"
