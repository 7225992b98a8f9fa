// bump-time: step the system wall clock by a signed millisecond delta.
//
// Usage: bump-time <delta-ms>
//
// Node-side helper for the clock nemesis (semantics match the reference's
// resource jepsen/resources/bump-time.c: a one-shot settimeofday jump).
// Compiled on each DB node by jepsen_tpu.nemesis.clock.

#include <cstdio>
#include <cstdlib>
#include <sys/time.h>

int main(int argc, char **argv) {
  if (argc != 2) {
    std::fprintf(stderr, "usage: %s <delta-ms>\n", argv[0]);
    return 2;
  }
  char *end = nullptr;
  const double delta_ms = std::strtod(argv[1], &end);
  if (end == argv[1] || *end != '\0') {
    std::fprintf(stderr, "bump-time: bad delta %s\n", argv[1]);
    return 2;
  }

  timeval tv;
  if (gettimeofday(&tv, nullptr) != 0) {
    std::perror("gettimeofday");
    return 1;
  }

  long long usec =
      static_cast<long long>(tv.tv_usec) +
      static_cast<long long>(delta_ms * 1000.0);
  long long sec = static_cast<long long>(tv.tv_sec) + usec / 1000000;
  usec %= 1000000;
  if (usec < 0) {
    usec += 1000000;
    sec -= 1;
  }
  tv.tv_sec = static_cast<time_t>(sec);
  tv.tv_usec = static_cast<suseconds_t>(usec);

  if (settimeofday(&tv, nullptr) != 0) {
    std::perror("settimeofday");
    return 1;
  }
  return 0;
}
