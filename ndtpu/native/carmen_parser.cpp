// Fast CARMEN 2D lidar log parser (native data-loader, SURVEY.md §3.1 L0).
//
// The reference's data layer is C++; this is its equivalent here:
// a single-pass strtod scanner (~50x the Python parser on large logs) with
// a C ABI consumed through ctypes (no pybind11 in this environment).
//
// Protocol: call carmen_parse(path) -> opaque handle; query sizes; copy
// rows out into caller-allocated buffers; free the handle.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Scan {
  std::vector<float> ranges;
  double laser_pose[3];
  double odom_pose[3];
  double timestamp;
};

struct ParseResult {
  std::vector<Scan> scans;
  int max_beams = 0;
  // First ROBOTLASER1 line's metadata: start_angle, fov, max_range.
  double meta[3] = {0, 0, 0};
  bool has_meta = false;
};

// Advance over whitespace, parse one double; returns false at end/error.
bool next_double(const char*& p, double& out) {
  char* end = nullptr;
  out = strtod(p, &end);
  if (end == p) return false;
  p = end;
  return true;
}

// True iff the next token is int-formatted (Python int() semantics,
// ADVICE r4): optional sign + digits only. A float-formatted token like
// "2.0" (a laser_x of 2.0 m) must NOT be treated as a remission count,
// matching the Python parser's int(tok) rejection.
bool int_token(const char* p) {
  while (*p == ' ' || *p == '\t') ++p;
  if (*p == '+' || *p == '-') ++p;
  if (*p < '0' || *p > '9') return false;
  while (*p >= '0' && *p <= '9') ++p;
  return *p == '\0' || *p == ' ' || *p == '\t' || *p == '\r' || *p == '\n';
}

// Count remaining whitespace-separated tokens from p (p not advanced).
int count_tokens(const char* p) {
  int n = 0;
  while (true) {
    while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
    if (!*p) return n;
    ++n;
    while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  }
}

}  // namespace

extern "C" {

void* carmen_parse(const char* path) {
  FILE* f = fopen(path, "r");
  if (!f) return nullptr;
  auto* res = new ParseResult();
  std::string line;
  char buf[1 << 16];
  while (fgets(buf, sizeof(buf), f)) {
    const char* p = buf;
    bool flaser = strncmp(p, "FLASER ", 7) == 0;
    bool rlaser = strncmp(p, "ROBOTLASER1 ", 12) == 0;
    if (!flaser && !rlaser) continue;
    p += flaser ? 7 : 12;
    double v;
    Scan s{};
    double meta[3] = {0, 0, 0};
    if (rlaser) {
      // laser_type start_angle fov ang_res max_range accuracy remission_mode
      for (int k = 0; k < 7; ++k) {
        if (!next_double(p, v)) goto bad;
        if (k == 1) meta[0] = v;         // start_angle
        if (k == 2) meta[1] = v;         // fov
        if (k == 4) meta[2] = v;         // max_range
      }
    }
    if (!next_double(p, v)) goto bad;
    {
      int n = static_cast<int>(v);
      if (n <= 0 || n > 100000) goto bad;
      s.ranges.resize(n);
      for (int k = 0; k < n; ++k) {
        if (!next_double(p, v)) goto bad;
        s.ranges[k] = static_cast<float>(v);
      }
      if (rlaser) {
        // Remission block probe, mirroring the Python parser (ADVICE r3):
        // the next token is the block's count only in the standard
        // dialect. Disambiguate from an integer-formatted laser_x by
        // total token count — a standard line carries exactly 6 pose +
        // 8 trailer = 14 tokens after the block.
        const char* p0 = p;
        if (!next_double(p, v)) goto bad;
        int nr = static_cast<int>(v);
        bool integral = int_token(p0) && (v == static_cast<double>(nr))
                        && nr >= 0;
        int after = count_tokens(p);  // tokens after the candidate count
        bool consume = false;
        if (integral) {
          if (after == nr + 14) consume = true;             // standard
          else if (after == 13) consume = false;            // laser_x == int
          else if (after >= nr + 6) consume = true;         // tolerant
        }
        if (consume) {
          for (int k = 0; k < nr; ++k)
            if (!next_double(p, v)) goto bad;
        } else {
          p = p0;  // no remission block: token was laser_x
        }
      }
      for (int k = 0; k < 3; ++k) {
        if (!next_double(p, v)) goto bad;
        s.laser_pose[k] = v;
      }
      for (int k = 0; k < 3; ++k) {
        if (!next_double(p, v)) goto bad;
        s.odom_pose[k] = v;
      }
      // FLASER trailer: timestamp host logger_ts.
      // ROBOTLASER1 trailer: tv rv forward_safety side_safety turn_axis
      // timestamp host logger_ts — skip the 5 motion/safety fields first.
      if (rlaser)
        for (int k = 0; k < 5; ++k)
          if (!next_double(p, v)) goto bad;
      s.timestamp = next_double(p, v) ? v : 0.0;
      if (rlaser && !res->has_meta) {
        memcpy(res->meta, meta, sizeof(meta));
        res->has_meta = true;
      }
      if (n > res->max_beams) res->max_beams = n;
      res->scans.push_back(std::move(s));
    }
    continue;
  bad:
    continue;  // skip malformed lines (reference parsers do the same)
  }
  fclose(f);
  return res;
}

int carmen_num_scans(void* h) {
  return h ? static_cast<int>(static_cast<ParseResult*>(h)->scans.size()) : 0;
}

int carmen_max_beams(void* h) {
  return h ? static_cast<ParseResult*>(h)->max_beams : 0;
}

// Copy into caller buffers: ranges [T * max_beams] padded with pad_value,
// n_beams [T], laser_pose [T*3], odom_pose [T*3], timestamps [T].
void carmen_fill(void* h, float* ranges, float pad_value, int* n_beams,
                 double* laser_pose, double* odom_pose, double* timestamps) {
  auto* res = static_cast<ParseResult*>(h);
  const int mb = res->max_beams;
  for (size_t t = 0; t < res->scans.size(); ++t) {
    const Scan& s = res->scans[t];
    const int n = static_cast<int>(s.ranges.size());
    float* row = ranges + t * mb;
    memcpy(row, s.ranges.data(), n * sizeof(float));
    for (int k = n; k < mb; ++k) row[k] = pad_value;
    n_beams[t] = n;
    memcpy(laser_pose + 3 * t, s.laser_pose, 3 * sizeof(double));
    memcpy(odom_pose + 3 * t, s.odom_pose, 3 * sizeof(double));
    timestamps[t] = s.timestamp;
  }
}

// Metadata of the first ROBOTLASER1 line: [start_angle, fov, max_range].
// Returns 1 when present, 0 for FLASER-only logs (out untouched).
int carmen_meta(void* h, double* out3) {
  auto* res = static_cast<ParseResult*>(h);
  if (!res || !res->has_meta) return 0;
  memcpy(out3, res->meta, 3 * sizeof(double));
  return 1;
}

void carmen_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
