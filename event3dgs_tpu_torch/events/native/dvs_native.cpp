// Native DVS event-camera simulator with a plain C interface.
//
// The port's copy of event3dgs_tpu/events/native/dvs_native.cpp (a
// behavioral reimplementation of the reference's `dsi` module,
// Event_sensor/ICNS_extern/simu.hpp + simu_cpp.cpp): the same ICNS pixel
// model as events/dvs_model.py, written struct-of-arrays in C++17 for fast
// offline event-stream synthesis.  The simulator core (struct Simu below)
// is the JAX package's, unchanged: per-pixel state in row-major arrays and
// one std::mt19937_64 seeded at creation, so one seed gives the same
// stream.  What differs is the binding: instead of a CPython module over
// Python lists, an `extern "C"` interface on raw arrays, loaded with
// ctypes (events/native/__init__.py), and one simulator per handle rather
// than one global.
//
// Every function returns 0 on success; dvs_update returns the number of
// events of the frame, which dvs_take_events then copies out.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <random>
#include <vector>

namespace {

struct Ev {
  uint64_t ts;
  uint16_t x, y;
  uint8_t p;
};

struct Simu {
  int w = 0, h = 0;  // image width (x) and height (y)
  double time = 0.0;
  // per-pixel state (row-major, index = y * w + x)
  std::vector<double> last_v, cur_v, tau_p, th_pos, th_neg;
  std::vector<double> time_px, cur_ref;  // cur_ref = +inf when open
  // parameters
  double m_th_pos = 0.3, m_th_neg = 0.3, m_th_noise = 0.0;
  double lat = 100.0, jit = 0.0, ref = 100.0, tau = 300.0;
  // background noise: per-pixel next event time (+inf = disabled) and CDFs
  std::vector<double> bgn_pos_next, bgn_neg_next;
  std::vector<double> hist_pos, hist_neg;  // n_px * 72
  std::vector<double> periods;             // 72 candidate periods
  bool noise_on = false;
  bool debug = false;
  std::mt19937_64 rng{12345};

  void resize(int W, int H) {
    w = W;
    h = H;
    size_t n = static_cast<size_t>(w) * h;
    last_v.assign(n, 0.0);
    cur_v.assign(n, 0.0);
    tau_p.assign(n, tau);
    th_pos.assign(n, m_th_pos);
    th_neg.assign(n, -m_th_neg);
    time_px.assign(n, 0.0);
    cur_ref.assign(n, inf());
    bgn_pos_next.assign(n, inf());
    bgn_neg_next.assign(n, inf());
    periods.resize(72);
    for (int i = -3; i < 5; i++)
      for (int j = 1; j < 10; j++)
        periods[(i + 3) * 9 + j - 1] = 1e6 / (j * std::pow(10.0, i));
  }

  static double inf() { return std::numeric_limits<double>::infinity(); }

  double normal(double mean, double sigma) {
    if (sigma <= 0.0) return mean;
    std::normal_distribution<double> d(mean, sigma);
    return d(rng);
  }

  double uniform() {
    std::uniform_real_distribution<double> d(0.0, 1.0);
    return d(rng);
  }

  void resample_th(size_t i, bool pos) {
    if (pos)
      th_pos[i] = std::max(0.0, normal(m_th_pos, m_th_noise));
    else
      th_neg[i] = std::min(0.0, normal(-m_th_neg, m_th_noise));
  }

  double draw_noise_wait(const std::vector<double>& hist, size_t i) {
    double prob = uniform();
    for (int j = 0; j < 72; j++)
      if (hist[i * 72 + j] >= prob) return periods[j];
    return inf();
  }

  void set_thresholds(double tp, double tn, double tnoise) {
    m_th_pos = tp;
    m_th_neg = tn;
    m_th_noise = tnoise;
    for (size_t i = 0; i < th_pos.size(); i++) {
      resample_th(i, true);
      resample_th(i, false);
    }
  }

  void init_noise(const std::vector<double>& hp, const std::vector<double>& hn,
                  long n_samples) {
    size_t n = static_cast<size_t>(w) * h;
    hist_pos.resize(n * 72);
    hist_neg.resize(n * 72);
    std::uniform_int_distribution<long> pick(0, n_samples - 1);
    for (size_t i = 0; i < n; i++) {
      long s = pick(rng);
      std::copy_n(hp.begin() + s * 72, 72, hist_pos.begin() + i * 72);
      std::copy_n(hn.begin() + s * 72, 72, hist_neg.begin() + i * 72);
      bgn_pos_next[i] = draw_noise_wait(hist_pos, i) * uniform();
      bgn_neg_next[i] = draw_noise_wait(hist_neg, i) * uniform();
    }
    noise_on = true;
  }

  void disable_noise() {
    std::fill(bgn_pos_next.begin(), bgn_pos_next.end(), inf());
    std::fill(bgn_neg_next.begin(), bgn_neg_next.end(), inf());
    noise_on = false;
  }

  void init_img(const std::vector<double>& img) {
    time = 0.0;
    size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; i++) {
      if (img[i] > 0) {
        double lv = std::log(img[i]);
        last_v[i] = cur_v[i] = lv;
        time_px[i] = 0.0;
        cur_ref[i] = inf();
      }
    }
  }

  void master_rst() {
    size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; i++) {
      last_v[i] = cur_v[i];
      cur_ref[i] = inf();
    }
  }

  // advance pixel i's filter to absolute time t toward img_l; when
  // sync_last, this is a refractory release (resets the event level)
  void lowpass_to(size_t i, double t, double img_l, bool sync_last) {
    double decay = 1.0 - std::exp(-std::max(t - time_px[i], 0.0) / tau_p[i]);
    double v = cur_v[i] + (img_l - cur_v[i]) * decay;
    cur_v[i] = v;
    time_px[i] = t;
    if (sync_last) {
      last_v[i] = v;
      cur_ref[i] = inf();
    }
  }

  void emit_noise(double dt, std::vector<Ev>& out) {
    if (!noise_on) return;
    double next_t = time + dt;
    size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; i++) {
      while (bgn_pos_next[i] < next_t) {
        out.push_back({static_cast<uint64_t>(bgn_pos_next[i]),
                       static_cast<uint16_t>(i % w),
                       static_cast<uint16_t>(i / w), 1});
        cur_ref[i] = bgn_pos_next[i];
        bgn_pos_next[i] += draw_noise_wait(hist_pos, i);
      }
      while (bgn_neg_next[i] < next_t) {
        out.push_back({static_cast<uint64_t>(bgn_neg_next[i]),
                       static_cast<uint16_t>(i % w),
                       static_cast<uint16_t>(i / w), 0});
        cur_ref[i] = bgn_neg_next[i];
        bgn_neg_next[i] += draw_noise_wait(hist_neg, i);
      }
    }
  }

  void update(const std::vector<double>& img, double dt, std::vector<Ev>& out) {
    emit_noise(dt, out);
    double t_end = time + dt;
    size_t n = static_cast<size_t>(w) * h;
    for (size_t i = 0; i < n; i++) {
      if (img[i] <= 0) continue;
      double img_l = std::log(img[i]);
      tau_p[i] = tau * std::log(255.0) / (img_l != 0.0 ? img_l : 1.0);
      if (cur_ref[i] < t_end) lowpass_to(i, cur_ref[i], img_l, true);
      double target =
          cur_v[i] + (img_l - cur_v[i]) *
                         (1.0 - std::exp(-std::max(t_end - time_px[i], 0.0) /
                                         tau_p[i]));
      int guard = 0;
      while (std::isinf(cur_ref[i]) && guard++ < 1024) {
        bool pos = target - last_v[i] > th_pos[i];
        bool neg = target - last_v[i] < th_neg[i];
        if (!pos && !neg) break;
        double th = pos ? th_pos[i] : th_neg[i];
        double delta = img_l - cur_v[i];
        double amp = (last_v[i] + th - cur_v[i]) / delta;
        double mean = lat - tau_p[i] * std::log1p(-amp);
        double sigma =
            std::sqrt(jit * jit +
                      std::pow(m_th_noise * tau_p[i] / delta, 2.0));
        double l = normal(mean, sigma);
        l = std::min(std::max(l, 0.0), 1e4);
        uint64_t t_ev = static_cast<uint64_t>(time_px[i] + l);
        out.push_back({t_ev, static_cast<uint16_t>(i % w),
                       static_cast<uint16_t>(i / w),
                       static_cast<uint8_t>(pos ? 1 : 0)});
        cur_ref[i] = static_cast<double>(t_ev) + ref;
        resample_th(i, pos);
        if (cur_ref[i] < t_end) lowpass_to(i, cur_ref[i], img_l, true);
      }
      lowpass_to(i, t_end, img_l, false);
    }
    time = t_end;
    std::stable_sort(out.begin(), out.end(),
                     [](const Ev& a, const Ev& b) { return a.ts < b.ts; });
  }
};

struct Handle {
  Simu simu;
  std::vector<Ev> events;  // the last update's events, until taken
};

}  // namespace

extern "C" {

void* dvs_create(int width, int height, uint64_t seed) {
  Handle* h = new (std::nothrow) Handle();
  if (!h) return nullptr;
  h->simu.resize(width, height);
  h->simu.rng.seed(seed);
  return h;
}

void dvs_destroy(void* handle) { delete static_cast<Handle*>(handle); }

int dvs_init_latency(void* handle, double lat, double jit, double ref,
                     double tau) {
  Simu& s = static_cast<Handle*>(handle)->simu;
  s.lat = lat;
  s.jit = jit;
  s.ref = ref;
  s.tau = tau;
  return 0;
}

int dvs_init_contrast(void* handle, double th_pos, double th_neg,
                      double th_noise) {
  static_cast<Handle*>(handle)->simu.set_thresholds(th_pos, th_neg, th_noise);
  return 0;
}

// hist_pos, hist_neg: [n_samples, 72] row-major CDFs
int dvs_init_noise(void* handle, const double* hist_pos,
                   const double* hist_neg, int64_t n_samples) {
  if (n_samples < 1) return 1;
  size_t n = static_cast<size_t>(n_samples) * 72;
  std::vector<double> hp(hist_pos, hist_pos + n), hn(hist_neg, hist_neg + n);
  static_cast<Handle*>(handle)->simu.init_noise(hp, hn, n_samples);
  return 0;
}

int dvs_disable_noise(void* handle) {
  static_cast<Handle*>(handle)->simu.disable_noise();
  return 0;
}

// img: width * height luminance values, row-major
int dvs_init_img(void* handle, const double* img) {
  Simu& s = static_cast<Handle*>(handle)->simu;
  s.init_img(std::vector<double>(img, img + static_cast<size_t>(s.w) * s.h));
  return 0;
}

int64_t dvs_update(void* handle, const double* img, double dt) {
  Handle* h = static_cast<Handle*>(handle);
  Simu& s = h->simu;
  h->events.clear();
  s.update(std::vector<double>(img, img + static_cast<size_t>(s.w) * s.h), dt,
           h->events);
  return static_cast<int64_t>(h->events.size());
}

// copies the last update's events out (each array as long as dvs_update
// returned) and forgets them
int dvs_take_events(void* handle, uint64_t* ts, uint16_t* x, uint16_t* y,
                    uint8_t* p) {
  Handle* h = static_cast<Handle*>(handle);
  for (size_t i = 0; i < h->events.size(); i++) {
    const Ev& e = h->events[i];
    ts[i] = e.ts;
    x[i] = e.x;
    y[i] = e.y;
    p[i] = e.p;
  }
  h->events.clear();
  return 0;
}

// out: width * height membrane voltages (the filtered log intensity)
int dvs_get_curv(void* handle, double* out) {
  const Simu& s = static_cast<Handle*>(handle)->simu;
  std::copy(s.cur_v.begin(), s.cur_v.end(), out);
  return 0;
}

}  // extern "C"
