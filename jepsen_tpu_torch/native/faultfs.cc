// faultfs: a fault-injecting passthrough FUSE filesystem.
//
// TPU-build counterpart of the CharybdeFS role in the reference
// (charybdefs/src/jepsen/charybdefs.clj:40-85 drives scylladb/charybdefs,
// a FUSE+Thrift service built from source on each DB node). This is an
// original, dependency-light redesign: instead of a Thrift control
// server, fault state is set by writing a command to the magic file
// `<mount>/.faultfs-ctl` (and read back from it), so the nemesis drives
// it over plain SSH with `echo`.
//
// Usage:   faultfs <backing-dir> <mountpoint> [fuse options...]
// Control: echo "eio 1"        > /faulty/.faultfs-ctl   # all ops fail EIO
//          echo "eio 0.01"     > /faulty/.faultfs-ctl   # 1% of ops fail
//          echo "errno 28 0.5" > /faulty/.faultfs-ctl   # 50% fail ENOSPC
//          echo "delay 100000 1" > /faulty/.faultfs-ctl # 100ms on every op
//          echo "clear"        > /faulty/.faultfs-ctl
//
// Like the reference's deployment, a DB points its data dir at the
// mountpoint; the nemesis flips fault modes mid-test.
//
// Build (on the DB node): g++ -O2 -o faultfs faultfs.cc \
//     $(pkg-config fuse --cflags --libs)

#define FUSE_USE_VERSION 26
#define _FILE_OFFSET_BITS 64

#include <fuse.h>

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>

#include <dirent.h>
#include <fcntl.h>
#include <pthread.h>
#include <sys/stat.h>
#include <sys/statvfs.h>
#include <sys/time.h>
#include <sys/types.h>
#include <unistd.h>

static std::string g_backing;

// Fault state, guarded by a mutex (FUSE runs multithreaded).
struct FaultState {
  int err = 0;           // errno to inject; 0 = none
  double probability = 0.0;
  long delay_us = 0;
  double delay_probability = 0.0;
};
static FaultState g_fault;
static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
static unsigned int g_seed;

static const char* kCtlPath = "/.faultfs-ctl";

static bool roll(double p) {
  if (p <= 0) return false;
  if (p >= 1) return true;
  return rand_r(&g_seed) < p * RAND_MAX;
}

// Returns 0, or a negative errno to inject for this operation.
static int fault_check() {
  pthread_mutex_lock(&g_mu);
  FaultState f = g_fault;
  pthread_mutex_unlock(&g_mu);
  if (f.delay_us > 0 && roll(f.delay_probability)) {
    usleep(static_cast<useconds_t>(f.delay_us));
  }
  if (f.err != 0 && roll(f.probability)) return -f.err;
  return 0;
}

static std::string real_path(const char* path) { return g_backing + path; }

static bool is_ctl(const char* path) { return strcmp(path, kCtlPath) == 0; }

static std::string ctl_render() {
  pthread_mutex_lock(&g_mu);
  FaultState f = g_fault;
  pthread_mutex_unlock(&g_mu);
  char buf[128];
  snprintf(buf, sizeof buf, "errno %d p %.6f delay_us %ld dp %.6f\n",
           f.err, f.probability, f.delay_us, f.delay_probability);
  return buf;
}

static void ctl_apply(const char* cmd) {
  FaultState next;
  double p = 1.0, dp = 1.0;
  long us = 0;
  int code = 0;
  if (sscanf(cmd, "eio %lf", &p) == 1) {
    next.err = EIO;
    next.probability = p;
  } else if (sscanf(cmd, "errno %d %lf", &code, &p) == 2) {
    next.err = code;
    next.probability = p;
  } else if (sscanf(cmd, "delay %ld %lf", &us, &dp) == 2) {
    next.delay_us = us;
    next.delay_probability = dp;
  }  // anything else (e.g. "clear") resets to no faults
  pthread_mutex_lock(&g_mu);
  g_fault = next;
  pthread_mutex_unlock(&g_mu);
}

#define FAULT_GATE()                 \
  do {                               \
    int fe_ = fault_check();         \
    if (fe_ != 0) return fe_;        \
  } while (0)

static int ff_getattr(const char* path, struct stat* st) {
  if (is_ctl(path)) {
    memset(st, 0, sizeof *st);
    st->st_mode = S_IFREG | 0666;
    st->st_nlink = 1;
    st->st_size = static_cast<off_t>(ctl_render().size());
    return 0;
  }
  // The mount root must stay stat-able during break-all, or path
  // resolution of the ctl file fails and faults become unclearable.
  if (strcmp(path, "/") != 0) FAULT_GATE();
  return lstat(real_path(path).c_str(), st) == 0 ? 0 : -errno;
}

static int ff_readlink(const char* path, char* buf, size_t size) {
  FAULT_GATE();
  ssize_t n = readlink(real_path(path).c_str(), buf, size - 1);
  if (n < 0) return -errno;
  buf[n] = '\0';
  return 0;
}

static int ff_mknod(const char* path, mode_t mode, dev_t rdev) {
  FAULT_GATE();
  return mknod(real_path(path).c_str(), mode, rdev) == 0 ? 0 : -errno;
}

static int ff_mkdir(const char* path, mode_t mode) {
  FAULT_GATE();
  return mkdir(real_path(path).c_str(), mode) == 0 ? 0 : -errno;
}

static int ff_unlink(const char* path) {
  FAULT_GATE();
  return unlink(real_path(path).c_str()) == 0 ? 0 : -errno;
}

static int ff_rmdir(const char* path) {
  FAULT_GATE();
  return rmdir(real_path(path).c_str()) == 0 ? 0 : -errno;
}

static int ff_symlink(const char* target, const char* link) {
  FAULT_GATE();
  return symlink(target, real_path(link).c_str()) == 0 ? 0 : -errno;
}

static int ff_rename(const char* from, const char* to) {
  FAULT_GATE();
  return rename(real_path(from).c_str(), real_path(to).c_str()) == 0
             ? 0 : -errno;
}

static int ff_link(const char* from, const char* to) {
  FAULT_GATE();
  return link(real_path(from).c_str(), real_path(to).c_str()) == 0
             ? 0 : -errno;
}

static int ff_chmod(const char* path, mode_t mode) {
  FAULT_GATE();
  return chmod(real_path(path).c_str(), mode) == 0 ? 0 : -errno;
}

static int ff_chown(const char* path, uid_t uid, gid_t gid) {
  FAULT_GATE();
  return lchown(real_path(path).c_str(), uid, gid) == 0 ? 0 : -errno;
}

static int ff_truncate(const char* path, off_t size) {
  // Shell `>` redirection truncates before writing; the ctl file has no
  // backing file and must stay reachable even while faults are active.
  if (is_ctl(path)) return 0;
  FAULT_GATE();
  return truncate(real_path(path).c_str(), size) == 0 ? 0 : -errno;
}

static int ff_utimens(const char* path, const struct timespec tv[2]) {
  if (is_ctl(path)) return 0;
  FAULT_GATE();
  return utimensat(AT_FDCWD, real_path(path).c_str(), tv,
                   AT_SYMLINK_NOFOLLOW) == 0 ? 0 : -errno;
}

static int ff_open(const char* path, struct fuse_file_info* fi) {
  if (is_ctl(path)) {
    fi->fh = static_cast<uint64_t>(-1);
    return 0;
  }
  FAULT_GATE();
  int fd = open(real_path(path).c_str(), fi->flags);
  if (fd < 0) return -errno;
  fi->fh = fd;
  return 0;
}

static int ff_create(const char* path, mode_t mode,
                     struct fuse_file_info* fi) {
  if (is_ctl(path)) {
    fi->fh = static_cast<uint64_t>(-1);
    return 0;
  }
  FAULT_GATE();
  int fd = open(real_path(path).c_str(), fi->flags, mode);
  if (fd < 0) return -errno;
  fi->fh = fd;
  return 0;
}

static int ff_read(const char* path, char* buf, size_t size, off_t off,
                   struct fuse_file_info* fi) {
  if (is_ctl(path)) {
    std::string s = ctl_render();
    if (off >= static_cast<off_t>(s.size())) return 0;
    size_t n = s.size() - off;
    if (n > size) n = size;
    memcpy(buf, s.data() + off, n);
    return static_cast<int>(n);
  }
  FAULT_GATE();
  ssize_t n = pread(static_cast<int>(fi->fh), buf, size, off);
  return n < 0 ? -errno : static_cast<int>(n);
}

static int ff_write(const char* path, const char* buf, size_t size,
                    off_t off, struct fuse_file_info* fi) {
  if (is_ctl(path)) {
    std::string cmd(buf, size);
    ctl_apply(cmd.c_str());
    return static_cast<int>(size);
  }
  FAULT_GATE();
  ssize_t n = pwrite(static_cast<int>(fi->fh), buf, size, off);
  return n < 0 ? -errno : static_cast<int>(n);
}

static int ff_statfs(const char* path, struct statvfs* st) {
  FAULT_GATE();
  return statvfs(real_path(path).c_str(), st) == 0 ? 0 : -errno;
}

static int ff_release(const char* path, struct fuse_file_info* fi) {
  if (is_ctl(path)) return 0;
  close(static_cast<int>(fi->fh));
  return 0;
}

static int ff_fsync(const char* path, int datasync,
                    struct fuse_file_info* fi) {
  if (is_ctl(path)) return 0;
  FAULT_GATE();
  int fd = static_cast<int>(fi->fh);
  int r = datasync ? fdatasync(fd) : fsync(fd);
  return r == 0 ? 0 : -errno;
}

static int ff_readdir(const char* path, void* buf, fuse_fill_dir_t fill,
                      off_t off, struct fuse_file_info* fi) {
  FAULT_GATE();
  DIR* dp = opendir(real_path(path).c_str());
  if (dp == nullptr) return -errno;
  struct dirent* de;
  while ((de = readdir(dp)) != nullptr) {
    if (fill(buf, de->d_name, nullptr, 0)) break;
  }
  closedir(dp);
  return 0;
}

static int ff_access(const char* path, int mask) {
  if (is_ctl(path)) return 0;
  FAULT_GATE();
  return access(real_path(path).c_str(), mask) == 0 ? 0 : -errno;
}

static int ff_ftruncate(const char* path, off_t size,
                        struct fuse_file_info* fi) {
  if (is_ctl(path)) return 0;
  FAULT_GATE();
  return ftruncate(static_cast<int>(fi->fh), size) == 0 ? 0 : -errno;
}

static struct fuse_operations ff_ops = {};

int main(int argc, char* argv[]) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <backing-dir> <mountpoint> [fuse opts]\n",
            argv[0]);
    return 2;
  }
  g_backing = argv[1];
  g_seed = static_cast<unsigned int>(time(nullptr)) ^ getpid();

  ff_ops.getattr = ff_getattr;
  ff_ops.readlink = ff_readlink;
  ff_ops.mknod = ff_mknod;
  ff_ops.mkdir = ff_mkdir;
  ff_ops.unlink = ff_unlink;
  ff_ops.rmdir = ff_rmdir;
  ff_ops.symlink = ff_symlink;
  ff_ops.rename = ff_rename;
  ff_ops.link = ff_link;
  ff_ops.chmod = ff_chmod;
  ff_ops.chown = ff_chown;
  ff_ops.truncate = ff_truncate;
  ff_ops.utimens = ff_utimens;
  ff_ops.open = ff_open;
  ff_ops.create = ff_create;
  ff_ops.read = ff_read;
  ff_ops.write = ff_write;
  ff_ops.statfs = ff_statfs;
  ff_ops.release = ff_release;
  ff_ops.fsync = ff_fsync;
  ff_ops.readdir = ff_readdir;
  ff_ops.access = ff_access;
  ff_ops.ftruncate = ff_ftruncate;

  // Drop argv[1] (backing dir) before handing the rest to FUSE.
  for (int i = 1; i < argc - 1; ++i) argv[i] = argv[i + 1];
  --argc;
  return fuse_main(argc, argv, &ff_ops, nullptr);
}
