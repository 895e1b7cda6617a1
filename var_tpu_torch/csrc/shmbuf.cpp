// shmbuf: POSIX shared-memory observation transport for ShmemVecEnv.
//
// The reference moves observations from env workers to the learner through
// per-(env, key) multiprocessing ctypes Arrays (reference:
// Envs/vec_env/shmem_vec_env.py:45-61), which the parent reassembles with
// one numpy copy per env per key. This library replaces that with ONE
// mmap'd POSIX segment laid out as contiguous batched (num_envs, *shape)
// regions per key: each worker writes its own row slice in place, and the
// parent's batched view needs a single copy per key (or none for
// zero-copy consumers). Synchronization is inherited from the command
// pipes exactly like the reference: a worker writes its slice before
// acknowledging the step, so the parent's read is ordered by the pipe
// recv (no locks on the segment itself).
//
// The port's copy of the JAX package's native/shmbuf.cpp. Plain C ABI,
// loaded via ctypes (var_tpu_torch/native.py::shmbuf); the mp.Array
// transport is chosen only by name, never as a fallback.
//
// Build: g++ -O3 -shared -fPIC shmbuf.cpp -o libshmbuf.so

#include <cerrno>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Create a new segment (exclusive) sized `size`. Returns fd or -errno.
int shmbuf_create(const char* name, long size) {
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) return -errno;
  if (ftruncate(fd, (off_t)size) != 0) {
    int e = errno;
    close(fd);
    shm_unlink(name);
    return -e;
  }
  return fd;
}

// Open an existing segment. Returns fd or -errno.
int shmbuf_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  return fd < 0 ? -errno : fd;
}

// Map `size` bytes of fd shared read/write. Returns address or 0.
void* shmbuf_map(int fd, long size) {
  void* p = mmap(nullptr, (size_t)size, PROT_READ | PROT_WRITE, MAP_SHARED,
                 fd, 0);
  return p == MAP_FAILED ? nullptr : p;
}

int shmbuf_unmap(void* p, long size) {
  return munmap(p, (size_t)size) == 0 ? 0 : -errno;
}

int shmbuf_close_fd(int fd) { return close(fd) == 0 ? 0 : -errno; }

int shmbuf_unlink(const char* name) {
  return shm_unlink(name) == 0 ? 0 : -errno;
}

}  // extern "C"
