// strobe-time: rapidly flip the wall clock between two offsets.
//
// Usage: strobe-time <delta-ms> <period-ms> <duration-s>
//
// For <duration-s> seconds, alternates the wall clock every <period-ms>
// between (monotonic + offset) and (monotonic + offset + delta), where
// offset is the wall-vs-monotonic offset sampled at startup. This keeps
// the clock marching forward on average while strobing it, the same
// behavior as the reference's jepsen/resources/strobe-time.c helper.
// Compiled on each DB node by jepsen_tpu.nemesis.clock.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <ctime>

namespace {

int64_t now_ns(clockid_t clk) {
  timespec ts;
  clock_gettime(clk, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000000000LL + ts.tv_nsec;
}

int set_wall_ns(int64_t ns) {
  timespec ts;
  ts.tv_sec = static_cast<time_t>(ns / 1000000000LL);
  ts.tv_nsec = static_cast<long>(ns % 1000000000LL);
  return clock_settime(CLOCK_REALTIME, &ts);
}

}  // namespace

int main(int argc, char **argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s <delta-ms> <period-ms> <duration-s>\n",
                 argv[0]);
    return 2;
  }
  const int64_t delta_ns = static_cast<int64_t>(
      std::strtod(argv[1], nullptr) * 1e6);
  const int64_t period_ns = static_cast<int64_t>(
      std::strtod(argv[2], nullptr) * 1e6);
  const int64_t duration_ns = static_cast<int64_t>(
      std::strtod(argv[3], nullptr) * 1e9);
  if (period_ns <= 0 || duration_ns < 0) {
    std::fprintf(stderr, "strobe-time: period must be > 0\n");
    return 2;
  }

  const int64_t start_mono = now_ns(CLOCK_MONOTONIC);
  const int64_t offset = now_ns(CLOCK_REALTIME) - start_mono;

  // Sleep granularity: check at least every period/4, at most 1 ms.
  timespec nap;
  const int64_t nap_ns = period_ns / 4 < 1000000LL ? period_ns / 4 : 1000000LL;
  nap.tv_sec = 0;
  nap.tv_nsec = static_cast<long>(nap_ns > 0 ? nap_ns : 1);

  int64_t mono = start_mono;
  while (mono - start_mono < duration_ns) {
    const int64_t phase = ((mono - start_mono) / period_ns) % 2;
    const int64_t target = mono + offset + (phase ? delta_ns : 0);
    if (set_wall_ns(target) != 0) {
      std::perror("clock_settime");
      return 1;
    }
    nanosleep(&nap, nullptr);
    mono = now_ns(CLOCK_MONOTONIC);
  }
  // Restore a sane clock: monotonic + original offset.
  if (set_wall_ns(mono + offset) != 0) {
    std::perror("clock_settime");
    return 1;
  }
  return 0;
}
