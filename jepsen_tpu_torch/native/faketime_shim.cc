// faketime_shim: LD_PRELOAD clock skew for a single process tree.
//
// TPU-build counterpart of the reference's libfaketime dependency
// (jepsen/src/jepsen/faketime.clj:8-22 clones and installs a fork of
// libfaketime on each node). Rather than fetching a third-party
// library, this is a minimal original shim implementing the same
// fault: the wrapped process sees
//
//     fake(t) = t0 + OFFSET + (t - t0) * RATE
//
// where t0 is the real time at the first intercepted call. Configured
// by environment variables:
//
//     JEPSEN_FAKETIME_OFFSET_S  initial offset, seconds (float, +/-)
//     JEPSEN_FAKETIME_RATE      clock rate multiplier (float, > 0)
//
// Intercepts clock_gettime (REALTIME + COARSE variants), gettimeofday,
// and time. Monotonic clocks are left honest, as with `faketime -m`.
//
// Build: g++ -O2 -fPIC -shared -o libfaketime_shim.so faketime_shim.cc -ldl

#define _GNU_SOURCE 1

#include <dlfcn.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/time.h>
#include <time.h>

typedef int (*clock_gettime_fn)(clockid_t, struct timespec*);
typedef int (*gettimeofday_fn)(struct timeval*, void*);

static clock_gettime_fn real_clock_gettime;
static gettimeofday_fn real_gettimeofday;
static pthread_once_t g_once = PTHREAD_ONCE_INIT;

static double g_offset = 0.0;
static double g_rate = 1.0;
static double g_anchor = 0.0;  // real seconds at first call

static void shim_init(void) {
  real_clock_gettime =
      (clock_gettime_fn)dlsym(RTLD_NEXT, "clock_gettime");
  real_gettimeofday = (gettimeofday_fn)dlsym(RTLD_NEXT, "gettimeofday");
  const char* off = getenv("JEPSEN_FAKETIME_OFFSET_S");
  const char* rate = getenv("JEPSEN_FAKETIME_RATE");
  if (off) g_offset = atof(off);
  if (rate) {
    double r = atof(rate);
    if (r > 0) g_rate = r;
  }
  struct timespec ts;
  if (real_clock_gettime && real_clock_gettime(CLOCK_REALTIME, &ts) == 0) {
    g_anchor = ts.tv_sec + ts.tv_nsec / 1e9;
  }
}

static double warp(double real) {
  return g_anchor + g_offset + (real - g_anchor) * g_rate;
}

static int faked_clock(clockid_t id) {
  return id == CLOCK_REALTIME || id == CLOCK_REALTIME_COARSE;
}

extern "C" int clock_gettime(clockid_t id, struct timespec* ts) {
  pthread_once(&g_once, shim_init);
  if (!real_clock_gettime) return -1;
  int r = real_clock_gettime(id, ts);
  if (r == 0 && faked_clock(id)) {
    double f = warp(ts->tv_sec + ts->tv_nsec / 1e9);
    ts->tv_sec = (time_t)f;
    ts->tv_nsec = (long)((f - (double)ts->tv_sec) * 1e9);
    if (ts->tv_nsec < 0) {
      ts->tv_nsec += 1000000000L;
      ts->tv_sec -= 1;
    }
  }
  return r;
}

extern "C" int gettimeofday(struct timeval* tv, void* tz) {
  pthread_once(&g_once, shim_init);
  if (!real_gettimeofday) return -1;
  int r = real_gettimeofday(tv, tz);
  if (r == 0 && tv) {
    double f = warp(tv->tv_sec + tv->tv_usec / 1e6);
    tv->tv_sec = (time_t)f;
    tv->tv_usec = (suseconds_t)((f - (double)tv->tv_sec) * 1e6);
    if (tv->tv_usec < 0) {
      tv->tv_usec += 1000000L;
      tv->tv_sec -= 1;
    }
  }
  return r;
}

extern "C" time_t time(time_t* out) {
  struct timespec ts;
  if (clock_gettime(CLOCK_REALTIME, &ts) != 0) return (time_t)-1;
  if (out) *out = ts.tv_sec;
  return ts.tv_sec;
}
