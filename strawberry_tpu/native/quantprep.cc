// Whole-pass quantification prep: for every locus in one call, compute the
// EM inputs (bin counts + bin-weight matrix) directly from flat RLE arrays.
//
// Ports the complete LocusContext observation model (ref: src/estimate.cpp:
// 115-277, include/isoform.h:105-516, include/interval.hpp:150-191) with the
// exact semantics of the Python oracles (quant/locus.py + quant/bins.py +
// quant/fastlocus.py, golden-validated against the reference binary):
//   * disjoint exon segments incl. the out-of-range reopen quirk
//   * read-vs-isoform compatibility (same kernel as compat.cc) + exon-seg
//     overlap rows + FNV fragment-set keys
//   * exon bins in first-encounter order; counts accumulate the FIRST
//     occurrence's mass per distinct fragment key (ExonBin::_frags set)
//   * theoretical bin weights: bin_under_iso implicit segments, the
//     closed-form / enumerated effective lengths (incl. the int/uint
//     bp_last `continue` quirk at isoform.h:485), pdf-table lookups, and
//     strictly sequential float64 accumulation in fragment-length order
//
// Output per locus: (nbins, counts[nbins], alpha[nbins x niso]) — consumed
// directly by the batched EM; no per-bin Python objects are ever built.

#include "perfcnt.h"
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <string>
#include <cstring>
#include <utility>
#include <thread>
#include <vector>

#include "quantprep.h"

using std::size_t;

namespace {
typedef int64_t i64;
typedef int32_t i32;
typedef int8_t i8;

struct Feats {
  const i64* off;
  const i8* code;
  const i64* left;
  const i32* len;
};

static inline i64 fright(const Feats& F, i64 f) {
  return F.left[f] + F.len[f] - 1;
}

// is_compatible(read h, isoform t) — identical to compat.cc's kernel.
static bool compat_hit_iso(const Feats& H, i64 h, const Feats& T, i64 t,
                           const std::vector<i64>& iso_exons) {
  i64 hb = H.off[h], he = H.off[h + 1];
  if (hb == he) return false;
  i64 first = hb;
  size_t lo = 0, hi = iso_exons.size();
  i64 fl = H.left[first];
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (fright(T, iso_exons[mid]) < fl) lo = mid + 1;
    else hi = mid;
  }
  if (lo == iso_exons.size()) return false;
  size_t it = lo;
  {
    i64 e = iso_exons[it];
    if (!(T.left[e] <= H.left[first] && fright(T, e) >= fright(H, first)))
      return false;
  }
  i64 tb = T.off[t], te = T.off[t + 1];
  for (i64 f = hb + 1; f < he; ++f) {
    i8 c = H.code[f];
    if (c == 2) continue;  // GAP
    if (c == 1) {          // INTRON: positional match
      i64 g = tb + 2 * (i64)it + 1;
      if (g >= te) return false;
      if (!(T.code[g] == 1 && T.left[g] == H.left[f] &&
            T.len[g] == H.len[f]))
        return false;
    } else {               // MATCH: advance to containing exon
      while (it < iso_exons.size()) {
        i64 e = iso_exons[it];
        if (T.left[e] <= H.left[f] && fright(T, e) >= fright(H, f)) break;
        ++it;
      }
      if (it == iso_exons.size()) return false;
    }
  }
  return true;
}

// ---- effective length (isoform.h:105-129 + 419-516) ----------------------
static i64 no_gap_ef(i64 l_left, i64 l_right, i64 l_int, i64 fl) {
  if (fl < l_int + 2) return 0;
  if (fl > l_left + l_right + l_int) return 0;
  i64 mid = fl - l_int - 1;
  return (l_left < mid ? l_left : mid) + (l_right < mid ? l_right : mid)
      - mid;
}

static i64 gap_ef(i64 l_left, i64 l_right, i64 l_int, i64 rl, i64 gap) {
  if (2 * rl + gap < l_int + 2) return 0;
  if (2 * rl + gap > l_left + l_right + l_int) return 0;
  i64 start = rl > l_left + l_int - gap - 1 ? rl : l_left + l_int - gap - 1;
  i64 lim = l_left + l_right + l_int - gap - rl;
  i64 end = l_left < lim ? l_left : lim;
  i64 v = end - start;
  return v > 0 ? v : 0;
}

// n >= 5 reference semantics: bitmask enumeration over first-segment
// offsets, with the reference's int-vs-uint comparison quirk (negative
// bp_last takes the `continue`, isoform.h:485). Kept as the oracle for
// effective_len_n5 below (tests fuzz them against each other); the hot
// path uses the closed form.
static i64 effective_len_n5_enum(const std::vector<i64>& s,
                                 const std::vector<i64>& implicit, i64 fl,
                                 i64 rl) {
  size_t n = s.size();
  size_t ni = n - 2;
  i64 inner_sum = 0;
  for (size_t k = 1; k + 1 < n; ++k) inner_sum += s[k];
  uint64_t target = ((uint64_t)1 << n) - 1;
  for (i64 ix : implicit) target &= ~((uint64_t)1 << ix);
  i64 num_pos = 0;
  for (i64 i = 1; i <= s[0]; ++i) {
    uint64_t hit = 1;
    i64 bp_last = fl - i - inner_sum;
    if (bp_last > s[n - 1] || bp_last < 0) continue;
    if (bp_last == 0) break;
    hit |= (uint64_t)1 << (n - 1);
    i64 last_rest = rl - bp_last;
    i64 j = (i64)ni;
    while (last_rest > 0 && j > 0) {
      hit |= (uint64_t)1 << j;
      last_rest -= s[j];
      j--;
    }
    i64 first_rest = rl - i;
    j = 1;
    while (first_rest > 0 && j <= (i64)ni) {
      hit |= (uint64_t)1 << j;
      first_rest -= s[j];
      j++;
    }
    if (hit == target) num_pos++;
  }
  return num_pos;
}

// Exact closed form of the n >= 5 enumeration: for fixed fl the candidate
// offsets i form ONE interval (bp_last in [1, s[n-1]], i <= s[0]); the
// left read covers inner prefix {1..jL(i)} (j covered iff i <= Lj :=
// rl - prefix_before(j) - 1) and the right read covers inner suffix
// {jR(i)..ni} (j covered iff i >= Rj := fl - rl - inner_sum +
// suffix_after(j) + 1). hit == target demands: every implicit index
// uncovered (i >= rl - pb(minI) and i <= Rmax(maxI) - 1) and every
// non-implicit inner index covered (i <= Lj or i >= Rj, i.e. i avoids the
// forbidden gap [Lj+1, Rj-1]). Lj and Rj both decrease with j, so the
// forbidden gaps sweep left monotonically and their union is mergeable in
// one pass — O(n) per fl instead of O(s[0]). Fuzz-validated value-equal
// to effective_len_n5_enum (tests/test_core_units.py).
static i64 effective_len_n5(const std::vector<i64>& s,
                            const std::vector<i64>& implicit, i64 fl,
                            i64 rl) {
  size_t n = s.size();
  i64 ni = (i64)n - 2;
  i64 inner_sum = 0;
  for (size_t k = 1; k + 1 < n; ++k) inner_sum += s[k];
  i64 lo = fl - inner_sum - s[n - 1];
  if (lo < 1) lo = 1;
  i64 hi = fl - inner_sum - 1;
  if (hi > s[0]) hi = s[0];
  if (lo > hi) return 0;
  // implicit indices must stay uncovered by either read
  std::vector<char> is_imp(ni + 1, 0);
  if (!implicit.empty()) {
    i64 min_i = implicit.front(), max_i = implicit.front();
    for (i64 ix : implicit) {
      is_imp[ix] = 1;
      if (ix < min_i) min_i = ix;
      if (ix > max_i) max_i = ix;
    }
    i64 pb = 0;  // prefix_before(min_i)
    for (i64 k = 1; k < min_i; ++k) pb += s[k];
    i64 b = rl - pb;  // i >= b keeps min_i (and all later) left-uncovered
    if (b > lo) lo = b;
    i64 sa = 0;  // suffix_after(max_i)
    for (i64 k = max_i + 1; k <= ni; ++k) sa += s[k];
    i64 c = fl - rl - inner_sum + sa;  // i <= c keeps max_i right-uncovered
    if (c < hi) hi = c;
    if (lo > hi) return 0;
  }
  // subtract the union of forbidden gaps of the non-implicit inner segs
  i64 count = hi - lo + 1;
  i64 pb = 0, sa = inner_sum;
  i64 cur_l = 0, cur_r = -1;  // current merged forbidden run (empty)
  for (i64 j = 1; j <= ni; ++j) {
    sa -= s[j];
    if (!is_imp[j]) {
      i64 Lj = rl - pb - 1;
      i64 Rj = fl - rl - inner_sum + sa + 1;
      i64 gl = Lj + 1, gr = Rj - 1;  // forbidden [gl, gr]
      if (gl < lo) gl = lo;
      if (gr > hi) gr = hi;
      if (gl <= gr) {
        if (cur_r < cur_l) {  // first run
          cur_l = gl;
          cur_r = gr;
        } else if (gr >= cur_l - 1 && gl <= cur_r + 1) {  // overlap/adjacent
          if (gl < cur_l) cur_l = gl;
          if (gr > cur_r) cur_r = gr;
        } else {  // disjoint: runs sweep left, flush the previous one
          count -= cur_r - cur_l + 1;
          cur_l = gl;
          cur_r = gr;
        }
      }
    }
    pb += s[j];
  }
  if (cur_r >= cur_l) count -= cur_r - cur_l + 1;
  return count;
}

// The whole fragment-length integral for an n>=5 bin:
//   w = sum_fl pdf[fl] * effective_len_n5(s, implicit, fl, rl) / (Lt-fl+1)
// with every fl-independent quantity of the closed form hoisted out of the
// loop (prefix/suffix sums, implicit bounds, the per-j gap endpoints —
// Lj is constant and Rj = fl + Kj). Bit-identical to calling
// effective_len_n5 per fl: the f64 accumulation sequence is unchanged.
static double weight_integral_n5(const std::vector<i64>& s,
                                 const std::vector<i64>& implicit,
                                 i64 lmin, i64 fl_hi, i64 rl, i64 Lt,
                                 const double* pdf) {
  size_t n = s.size();
  i64 ni = (i64)n - 2;
  i64 inner_sum = 0;
  for (size_t k = 1; k + 1 < n; ++k) inner_sum += s[k];
  // per-j constants for the non-implicit forbidden gaps
  static thread_local std::vector<i64> gl_v, kgr_v;
  static thread_local std::vector<char> imp_v;
  gl_v.clear();
  kgr_v.clear();
  imp_v.assign(ni + 1, 0);
  i64 min_i = 0, max_i = 0;
  if (!implicit.empty()) {
    min_i = max_i = implicit.front();
    for (i64 ix : implicit) {
      imp_v[ix] = 1;
      if (ix < min_i) min_i = ix;
      if (ix > max_i) max_i = ix;
    }
  }
  {
    i64 pb = 0, sa = inner_sum;
    for (i64 j = 1; j <= ni; ++j) {
      sa -= s[j];
      if (!imp_v[j]) {
        gl_v.push_back(rl - pb);                  // Lj + 1
        kgr_v.push_back(-rl - inner_sum + sa);    // Rj - 1 = fl + this
      }
      pb += s[j];
    }
  }
  i64 b_lo = 0, c_k = 0;
  bool has_imp = !implicit.empty();
  if (has_imp) {
    i64 pb = 0;
    for (i64 k = 1; k < min_i; ++k) pb += s[k];
    b_lo = rl - pb;                               // lo >= this
    i64 sa = 0;
    for (i64 k = max_i + 1; k <= ni; ++k) sa += s[k];
    c_k = -rl - inner_sum + sa;                   // hi <= fl + this
  }
  size_t ng = gl_v.size();
  double w = 0.0;
  for (i64 fl = lmin; fl <= fl_hi; ++fl) {
    i64 lo = fl - inner_sum - s[n - 1];
    if (lo < 1) lo = 1;
    i64 hi = fl - inner_sum - 1;
    if (hi > s[0]) hi = s[0];
    if (has_imp) {
      if (b_lo > lo) lo = b_lo;
      i64 c = fl + c_k;
      if (c < hi) hi = c;
    }
    i64 count = 0;
    if (lo <= hi) {
      count = hi - lo + 1;
      i64 cur_l = 0, cur_r = -1;
      for (size_t g = 0; g < ng; ++g) {
        i64 gl = gl_v[g], gr = fl + kgr_v[g];
        if (gl < lo) gl = lo;
        if (gr > hi) gr = hi;
        if (gl <= gr) {
          if (cur_r < cur_l) {
            cur_l = gl;
            cur_r = gr;
          } else if (gr >= cur_l - 1 && gl <= cur_r + 1) {
            if (gl < cur_l) cur_l = gl;
            if (gr > cur_r) cur_r = gr;
          } else {
            count -= cur_r - cur_l + 1;
            cur_l = gl;
            cur_r = gr;
          }
        }
      }
      if (cur_r >= cur_l) count -= cur_r - cur_l + 1;
    }
    double p = (fl >= 0) ? pdf[fl] : 0.0;
    w += p * (double)count / (double)(Lt - fl + 1);
  }
  return w;
}

static i64 effective_len(const std::vector<i64>& s,
                         const std::vector<i64>& implicit, i64 fl, i64 rl) {
  i64 gap = fl - 2 * rl;
  size_t n = s.size();
  if (n == 1) return s[0] - fl + 1;
  if (n == 2) return no_gap_ef(s[0], s[1], 0, fl);
  if (n == 3) {
    if (implicit.size() == 1) return gap_ef(s[0], s[2], s[1], rl, gap);
    return no_gap_ef(s[0], s[2], s[1], fl) - gap_ef(s[0], s[2], s[1], rl,
                                                    gap);
  }
  if (n == 4) {
    i64 h14 = gap_ef(s[0], s[3], s[2] + s[1], rl, gap);
    i64 h24 = gap_ef(s[3], s[1], s[2], rl, gap);
    i64 h124 = gap_ef(s[0] + s[1], s[3], s[2], rl, gap);
    i64 h13 = gap_ef(s[0], s[2], s[1], rl, gap);
    i64 h134 = gap_ef(s[0], s[2] + s[3], s[1], rl, gap);
    if (implicit.empty()) {
      i64 total = no_gap_ef(s[0], s[3], s[1] + s[2], fl);
      return total - (h124 - h14 - h24) - (h134 - h14 - h13) - h14;
    }
    if (implicit.size() == 2) return h14;
    if (implicit[0] == 1) return h134 - h14 - h13;
    return h124 - h14 - h24;
  }
  return effective_len_n5(s, implicit, fl, rl);
}

// disjoint exon segments (interval.hpp:150-191) incl. the out-of-range
// reopen quirk — shared by the locus kernel and the standalone segs batch
static void disjoint_segs(const i64* t_off, const i8* t_code,
                          const i64* t_left, const i32* t_len,
                          const i64* iso_ids, i64 ni,
                          std::vector<i64>& seg_l, std::vector<i64>& seg_r) {
  std::vector<std::pair<i64, i64>> raw;  // unique (left,len), sorted
  for (i64 ti = 0; ti < ni; ++ti) {
    i64 t = iso_ids[ti];
    for (i64 f = t_off[t]; f < t_off[t + 1]; ++f)
      if (t_code[f] == 0) raw.push_back({t_left[f], (i64)t_len[f]});
  }
  std::sort(raw.begin(), raw.end());
  raw.erase(std::unique(raw.begin(), raw.end()), raw.end());
  if (raw.empty()) return;
  i64 hi = 0;
  std::vector<i64> bars;
  for (auto& p : raw) {
    i64 e = p.first + p.second;  // half-open end
    if (e > hi) hi = e;
    bars.push_back(p.first);
    bars.push_back(e);
  }
  // cov[x] > 0 <=> x lies in the union of the half-open raw intervals;
  // the per-base vector only ever answered point queries at bar
  // positions, so merge the (sorted) intervals into maximal runs and
  // binary-search instead of filling O(span) counters per locus
  std::vector<std::pair<i64, i64>> runs;  // half-open [l, e)
  for (auto& p : raw) {
    i64 e = p.first + p.second;
    if (!runs.empty() && p.first <= runs.back().second) {
      if (e > runs.back().second) runs.back().second = e;
    } else {
      runs.push_back({p.first, e});
    }
  }
  auto covered = [&](i64 x) {
    size_t k = (size_t)(std::upper_bound(
                            runs.begin(), runs.end(),
                            std::make_pair(x, (i64)INT64_MAX)) -
                        runs.begin());
    return k > 0 && x < runs[k - 1].second;
  };
  std::sort(bars.begin(), bars.end());
  bars.erase(std::unique(bars.begin(), bars.end()), bars.end());
  bool have_pending = false;
  i64 pending = 0;
  for (size_t bi = 0; bi < bars.size(); ++bi) {
    i64 b = bars[bi];
    if (!have_pending) {
      pending = b;
      have_pending = true;
    } else {
      seg_l.push_back(pending);
      seg_r.push_back(b - 1);  // closed right end
      // reference reads cov[b-lo] even one-past-the-end (UB read,
      // interval.hpp:178); out-of-range == don't reopen
      if (b < hi && covered(b)) bi--;
      have_pending = false;
    }
  }
  // trailing unmatched left dropped (reference pops it)
}

}  // namespace

extern "C" {

struct StrawbQuant {
  std::vector<i64> nbins;      // per locus
  std::vector<i64> bin_off;    // n_loci+1 -> counts
  std::vector<double> counts;  // flat per bin
  std::vector<i64> alpha_off;  // n_loci+1 -> alpha
  std::vector<double> alpha;   // flat (nbins x niso) row-major per locus
};

// Batched quant prep over one pass's loci.
//   hit_loc_off / iso_loc_off: (n_loci+1) hit / transcript index ranges.
//   h_*: flat RLE over all loci's valid uniq contigs; h_mass per contig.
//   t_*: flat RLE over all loci's transcripts; t_exlen = exonic lengths.
//   pdf: dense emp_dist_pdf table indexed by fragment length (must cover
//        the largest transcript exonic length).
//   base_lmin: insert_dist.start_offset (empirical) or read_len.
//   long_read: weight = 1/exonic_length instead of the pdf integral.
StrawbQuant* strawb_quant_batch(
    i64 n_loci, const i64* hit_loc_off, const i64* iso_loc_off,
    const i64* h_off, const i8* h_code, const i64* h_left, const i32* h_len,
    const double* h_mass,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len,
    const i64* t_exlen,
    const double* pdf, i64 pdf_len,
    i64 read_len, i64 base_lmin, i32 long_read) {
  auto* Q = new StrawbQuant();
  Q->bin_off.push_back(0);
  Q->alpha_off.push_back(0);

  // loci are independent: process contiguous ranges on a small pool and
  // concatenate partial outputs in locus order (split points balanced by
  // hit count, the dominant cost driver)
  auto process_range = [&](i64 L_lo, i64 L_hi, StrawbQuant& P) {
    std::vector<i64> ids;
    QuantLocusOut out;
    for (i64 L = L_lo; L < L_hi; ++L) {
      i64 tbeg = iso_loc_off[L], tend = iso_loc_off[L + 1];
      ids.clear();
      for (i64 t = tbeg; t < tend; ++t) ids.push_back(t);
      out.counts.clear();
      out.alpha.clear();
      strawb_quant_locus(h_off, h_code, h_left, h_len, h_mass,
                         hit_loc_off[L], hit_loc_off[L + 1],
                         t_off, t_code, t_left, t_len, ids.data(),
                         (i64)ids.size(), t_exlen, pdf, pdf_len, read_len,
                         base_lmin, long_read, out);
      P.counts.insert(P.counts.end(), out.counts.begin(), out.counts.end());
      P.alpha.insert(P.alpha.end(), out.alpha.begin(), out.alpha.end());
      P.nbins.push_back((i64)out.counts.size());
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  size_t TN = hw > 1 ? (hw < 8 ? hw : 8) : 1;
  if (n_loci < 64) TN = 1;
  std::vector<StrawbQuant> parts(TN);
  if (TN == 1) {
    process_range(0, n_loci, parts[0]);
  } else {
    // split points ~equal in total hits
    i64 total_h = hit_loc_off[n_loci];
    std::vector<i64> cut(TN + 1, n_loci);
    cut[0] = 0;
    {
      i64 L = 0;
      for (size_t t = 1; t < TN; ++t) {
        i64 want = total_h * (i64)t / (i64)TN;
        while (L < n_loci && hit_loc_off[L] < want) ++L;
        cut[t] = L;
      }
    }
    std::vector<std::thread> pool;
    for (size_t t = 0; t < TN; ++t)
      pool.emplace_back([&, t]() { process_range(cut[t], cut[t + 1],
                                                 parts[t]); });
    for (auto& th : pool) th.join();
  }

  for (size_t t = 0; t < TN; ++t) {
    StrawbQuant& P = parts[t];
    Q->counts.insert(Q->counts.end(), P.counts.begin(), P.counts.end());
    Q->alpha.insert(Q->alpha.end(), P.alpha.begin(), P.alpha.end());
    i64 Lbase = (i64)Q->nbins.size();
    for (size_t k = 0; k < P.nbins.size(); ++k) {
      i64 ni = iso_loc_off[Lbase + (i64)k + 1] - iso_loc_off[Lbase + (i64)k];
      Q->bin_off.push_back(Q->bin_off.back() + P.nbins[k]);
      Q->alpha_off.push_back(Q->alpha_off.back() + P.nbins[k] * ni);
      Q->nbins.push_back(P.nbins[k]);
    }
  }
  return Q;
}

}  // extern "C"

// One locus' bins + theoretical weights (C++ linkage; see quantprep.h).
// Shared by the batch entry above and the fused pass-2 clusterizer.
void strawb_quant_locus(
    const i64* h_off, const i8* h_code, const i64* h_left, const i32* h_len,
    const double* h_mass, i64 hbeg, i64 hend,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len,
    const i64* iso_ids, i64 ni, const i64* t_exlen,
    const double* pdf, i64 pdf_len, i64 read_len, i64 base_lmin,
    i32 long_read, QuantLocusOut& P_out) {
  strawb_quant_locus_pre(h_off, h_code, h_left, h_len, h_mass, hbeg, hend,
                         t_off, t_code, t_left, t_len, iso_ids, ni, t_exlen,
                         pdf, pdf_len, read_len, base_lmin, long_read,
                         nullptr, nullptr, 0, P_out);
}

// Variant taking PRECOMPUTED per-(hit,iso) compatibility (hit-major 0/1
// bytes) and per-hit packed seg-overlap bit rows — the integer halves that
// the JAX device computes bit-exactly (quant/device_prep.py). Passing nullptrs
// recomputes both on host (the original all-host path).
void strawb_quant_locus_pre(
    const i64* h_off, const i8* h_code, const i64* h_left, const i32* h_len,
    const double* h_mass, i64 hbeg, i64 hend,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len,
    const i64* iso_ids, i64 ni, const i64* t_exlen,
    const double* pdf, i64 pdf_len, i64 read_len, i64 base_lmin,
    i32 long_read, const uint8_t* compat_pre, const uint8_t* rows_pre,
    i64 row_bytes, QuantLocusOut& P_out) {
  strawb_perf::Scope _ps(strawb_perf::kQuantPrep);
  Feats H{h_off, h_code, h_left, h_len};
  Feats T{t_off, t_code, t_left, t_len};
  i64 nh = hend - hbeg;
  std::vector<i64> seg_l, seg_r;
  std::vector<std::vector<i64>> iso_exons;   // per iso: exon feat indices
  std::vector<std::vector<i64>> iso_segs;    // per iso: compatible seg ids
  std::vector<std::vector<uint8_t>> rows;    // per bin: seg membership
  std::vector<double> counts;
  std::vector<std::vector<uint8_t>> bin_hit_iso;
  {
    // ---- disjoint exon segments (interval.hpp:150-191) -----------------
    disjoint_segs(t_off, t_code, t_left, t_len, iso_ids, ni, seg_l, seg_r);
    i64 ns = (i64)seg_l.size();

    // ---- per-iso exon lists + compatible segs (is_compatible_feat) -----
    iso_exons.assign(ni, {});
    iso_segs.assign(ni, {});
    for (i64 t = 0; t < ni; ++t) {
      for (i64 f = t_off[iso_ids[t]]; f < t_off[iso_ids[t] + 1]; ++f)
        if (t_code[f] == 0) iso_exons[t].push_back(f);
      const auto& exv = iso_exons[t];
      for (i64 s = 0; s < ns; ++s) {
        size_t lo2 = 0, hi2 = exv.size();
        while (lo2 < hi2) {
          size_t mid = (lo2 + hi2) / 2;
          if (fright(T, exv[mid]) < seg_l[s]) lo2 = mid + 1;
          else hi2 = mid;
        }
        if (lo2 == exv.size()) continue;
        i64 e = exv[lo2];
        if (T.left[e] <= seg_l[s] && fright(T, e) >= seg_r[s])
          iso_segs[t].push_back(s);
      }
    }

    // ---- hits -> bins (first-encounter order) --------------------------
    // flat open-addressing tables instead of unordered_map<string>/
    // per-bin unordered_set: the node + string mallocs were two heap
    // allocations per hit on the hot quantification path
    rows.clear();
    counts.clear();
    bin_hit_iso.clear();
    struct RowSlot { uint64_t h; i64 bin; };   // bin -1 = empty
    size_t row_cap = 64;
    std::vector<RowSlot> row_tab(row_cap, {0, -1});
    struct FragSlot { uint64_t fk; i64 bin; };  // bin -1 = empty
    size_t frag_cap = 256;
    std::vector<FragSlot> frag_tab(frag_cap, {0, -1});
    size_t frag_used = 0;
    std::vector<char> cc(ni);
    std::vector<uint8_t> row(ns);
    auto row_hash = [&](const uint8_t* r) {
      uint64_t x = 0xcbf29ce484222325ull;
      for (i64 s = 0; s < ns; ++s) x = (x ^ r[s]) * 1099511628211ull;
      return x;
    };

    for (i64 h = 0; h < nh; ++h) {
      i64 hh = hbeg + h;
      bool any = false;
      if (compat_pre != nullptr) {
        const uint8_t* cp = compat_pre + h * ni;
        for (i64 t = 0; t < ni; ++t) {
          cc[t] = cp[t];
          any |= cc[t];
        }
      } else {
        for (i64 t = 0; t < ni; ++t) {
          cc[t] = compat_hit_iso(H, hh, T, iso_ids[t], iso_exons[t]) ? 1 : 0;
          any |= cc[t];
        }
      }
      if (!any) continue;
      bool nonempty = false;
      if (rows_pre != nullptr) {
        const uint8_t* rp = rows_pre + h * row_bytes;
        for (i64 s = 0; s < ns; ++s) {
          uint8_t hit = (rp[s >> 3] >> (s & 7)) & 1;
          row[s] = hit;
          nonempty |= hit;
        }
      } else {
        for (i64 s = 0; s < ns; ++s) {
          uint8_t hit = 0;
          for (i64 f = h_off[hh]; f < h_off[hh + 1] && !hit; ++f) {
            if (h_code[f] != 0) continue;
            if (h_left[f] <= seg_r[s] && seg_l[s] <= fright(H, f)) hit = 1;
          }
          row[s] = hit;
          nonempty |= hit;
        }
      }
      if (!nonempty) continue;
      // bin lookup: hash of the row bytes, exact-compare on probe (first-
      // encounter bin order preserved)
      uint64_t rh = row_hash(row.data());
      i64 b = -1;
      {
        if ((rows.size() + 1) * 4 >= row_cap * 3) {
          size_t nc = row_cap * 2;
          std::vector<RowSlot> nt(nc, {0, -1});
          for (const RowSlot& s : row_tab)
            if (s.bin >= 0) {
              size_t i2 = (size_t)s.h & (nc - 1);
              while (nt[i2].bin >= 0) i2 = (i2 + 1) & (nc - 1);
              nt[i2] = s;
            }
          row_tab.swap(nt);
          row_cap = nc;
        }
        size_t i2 = (size_t)rh & (row_cap - 1);
        for (;;) {
          RowSlot& s = row_tab[i2];
          if (s.bin < 0) {
            b = (i64)rows.size();
            s.h = rh;
            s.bin = b;
            rows.push_back(std::vector<uint8_t>(row.begin(), row.end()));
            counts.push_back(0.0);
            bin_hit_iso.push_back(std::vector<uint8_t>(ni, 0));
            break;
          }
          if (s.h == rh &&
              std::memcmp(rows[s.bin].data(), row.data(), ns) == 0) {
            b = s.bin;
            break;
          }
          i2 = (i2 + 1) & (row_cap - 1);
        }
      }
      // fragment-set dedupe key: FNV over (left,len) pairs (compat.cc);
      // membership is exact on (bin, fk)
      uint64_t fk = 0xcbf29ce484222325ull;
      for (i64 f = h_off[hh]; f < h_off[hh + 1]; ++f) {
        fk = (fk ^ (uint64_t)h_left[f]) * 1099511628211ull;
        fk = (fk ^ (uint64_t)(uint32_t)h_len[f]) * 1099511628211ull;
      }
      {
        if ((frag_used + 1) * 4 >= frag_cap * 3) {
          size_t nc = frag_cap * 2;
          std::vector<FragSlot> nt(nc, {0, -1});
          for (const FragSlot& s : frag_tab)
            if (s.bin >= 0) {
              uint64_t hh2 = (s.fk ^ ((uint64_t)s.bin * 0x9E3779B97F4A7C15ull));
              hh2 ^= hh2 >> 29;
              size_t i2 = (size_t)hh2 & (nc - 1);
              while (nt[i2].bin >= 0) i2 = (i2 + 1) & (nc - 1);
              nt[i2] = s;
            }
          frag_tab.swap(nt);
          frag_cap = nc;
        }
        uint64_t hh2 = (fk ^ ((uint64_t)b * 0x9E3779B97F4A7C15ull));
        hh2 ^= hh2 >> 29;
        size_t i2 = (size_t)hh2 & (frag_cap - 1);
        for (;;) {
          FragSlot& s = frag_tab[i2];
          if (s.bin < 0) {
            s.fk = fk;
            s.bin = b;
            frag_used++;
            counts[b] += h_mass[hh];
            break;
          }
          if (s.fk == fk && s.bin == b) break;  // already counted
          i2 = (i2 + 1) & (frag_cap - 1);
        }
      }
      for (i64 t = 0; t < ni; ++t)
        if (cc[t]) bin_hit_iso[b][t] |= cc[t];
    }

    i64 nbins = (i64)rows.size();

    // ---- theoretical weights per (iso, bin) ----------------------------
    strawb_perf::Scope _pw(strawb_perf::kQuantWeights);
    std::vector<double> alpha((size_t)(nbins * ni), 0.0);
    std::vector<i64> seg_lens, implicit;
    // per-bin seg lists hoisted out of the isoform loop (they were being
    // rebuilt for every (bin, isoform) pair)
    std::vector<std::vector<i64>> bins_segs((size_t)nbins);
    for (i64 b = 0; b < nbins; ++b)
      for (i64 s = 0; s < ns; ++s)
        if (rows[b][s]) bins_segs[b].push_back(s);
    // last fragment length with a non-zero pdf value: beyond it every term
    // of the weight integral is p*eff/(Lt-fl+1) with p == 0.0, i.e.
    // exactly +/-0.0, and adding a zero never changes the accumulated w —
    // so the tail is skippable bit-for-bit (big transcripts otherwise walk
    // thousands of dead iterations per pair)
    i64 pdf_nz = pdf_len - 1;
    while (pdf_nz >= 0 && pdf[pdf_nz] == 0.0) --pdf_nz;

    for (i64 t = 0; t < ni; ++t) {
      const auto& segs_t = iso_segs[t];
      i64 Lt = t_exlen[iso_ids[t]];
      double inv_len = long_read ? 1.0 / (double)Lt : 0.0;
      for (i64 b = 0; b < nbins; ++b) {
        if (!bin_hit_iso[b][t]) continue;
        if (long_read) {
          alpha[(size_t)(b * ni + t)] = inv_len;
          continue;
        }
        const std::vector<i64>& bin_segs = bins_segs[b];
        // bin_under_iso (isoform.h:363-411): iso segs spanning the bin,
        // and indices of implicit (gap-skipped) inner segments
        i64 first_left = seg_l[bin_segs.front()];
        i64 last_left = seg_l[bin_segs.back()];
        size_t low, up;
        {
          size_t lo2 = 0, hi2 = segs_t.size();
          while (lo2 < hi2) {
            size_t mid = (lo2 + hi2) / 2;
            if (seg_l[segs_t[mid]] < first_left) lo2 = mid + 1;
            else hi2 = mid;
          }
          low = lo2;
          lo2 = 0;
          hi2 = segs_t.size();
          while (lo2 < hi2) {
            size_t mid = (lo2 + hi2) / 2;
            if (seg_l[segs_t[mid]] < last_left) lo2 = mid + 1;
            else hi2 = mid;
          }
          up = lo2;
        }
        size_t cnt = up - low + 1;
        seg_lens.clear();
        for (size_t k = 0; k < cnt; ++k) {
          i64 sg = segs_t[low + k];
          seg_lens.push_back(seg_r[sg] - seg_l[sg] + 1);
        }
        implicit.clear();
        {
          size_t ci = 1, i2 = 1;
          while (i2 + 1 < cnt) {
            i64 ecl = seg_l[segs_t[low + i2]];
            i64 bcl = ci < bin_segs.size() ? seg_l[bin_segs[ci]] : INT64_MAX;
            if (ecl < bcl) {
              implicit.push_back((i64)i2);
              ++i2;
            } else {  // equal (greater impossible on compatible inputs)
              ++i2;
              ++ci;
            }
          }
        }
        i64 lmax = 0;
        for (i64 v : seg_lens) lmax += v;
        i64 lmin = base_lmin;
        if (seg_lens.size() > 2) {
          i64 inner = 0;
          for (size_t k = 1; k + 1 < seg_lens.size(); ++k)
            inner += seg_lens[k];
          if (inner > lmin) lmin = inner;
        }
        double w = 0.0;
        i64 fl_hi = lmax < pdf_nz ? lmax : pdf_nz;  // zero-pdf tail skipped
        if (seg_lens.size() == 1) {
          i64 s0 = seg_lens[0];
          for (i64 fl = lmin; fl <= fl_hi; ++fl) {
            double p = (fl >= 0) ? pdf[fl] : 0.0;
            w += p * (double)(s0 - fl + 1) / (double)(Lt - fl + 1);
          }
        } else if (seg_lens.size() >= 5) {
          w = weight_integral_n5(seg_lens, implicit, lmin, fl_hi,
                                 read_len, Lt, pdf);
        } else if (seg_lens.size() == 2) {
          i64 s0 = seg_lens[0], s1 = seg_lens[1];
          for (i64 fl = lmin; fl <= fl_hi; ++fl) {
            double p = (fl >= 0) ? pdf[fl] : 0.0;
            i64 eff = no_gap_ef(s0, s1, 0, fl);
            w += p * (double)eff / (double)(Lt - fl + 1);
          }
        } else if (seg_lens.size() == 3) {
          i64 s0 = seg_lens[0], s1 = seg_lens[1], s2 = seg_lens[2];
          i64 rl2 = 2 * read_len;
          if (implicit.size() == 1) {
            for (i64 fl = lmin; fl <= fl_hi; ++fl) {
              double p = (fl >= 0) ? pdf[fl] : 0.0;
              i64 eff = gap_ef(s0, s2, s1, read_len, fl - rl2);
              w += p * (double)eff / (double)(Lt - fl + 1);
            }
          } else {
            for (i64 fl = lmin; fl <= fl_hi; ++fl) {
              double p = (fl >= 0) ? pdf[fl] : 0.0;
              i64 eff = no_gap_ef(s0, s2, s1, fl) -
                        gap_ef(s0, s2, s1, read_len, fl - rl2);
              w += p * (double)eff / (double)(Lt - fl + 1);
            }
          }
        } else {  // n == 4: hoist the implicit-config dispatch
          i64 s0 = seg_lens[0], s1 = seg_lens[1], s2 = seg_lens[2],
              s3 = seg_lens[3];
          i64 rl = read_len, rl2 = 2 * read_len;
          int mode = implicit.empty() ? 0
                     : implicit.size() == 2 ? 1
                     : implicit[0] == 1 ? 2 : 3;
          for (i64 fl = lmin; fl <= fl_hi; ++fl) {
            double p = (fl >= 0) ? pdf[fl] : 0.0;
            i64 gap = fl - rl2;
            i64 h14 = gap_ef(s0, s3, s2 + s1, rl, gap);
            i64 eff;
            if (mode == 1) {
              eff = h14;
            } else if (mode == 2) {
              i64 h13 = gap_ef(s0, s2, s1, rl, gap);
              i64 h134 = gap_ef(s0, s2 + s3, s1, rl, gap);
              eff = h134 - h14 - h13;
            } else if (mode == 3) {
              i64 h24 = gap_ef(s3, s1, s2, rl, gap);
              i64 h124 = gap_ef(s0 + s1, s3, s2, rl, gap);
              eff = h124 - h14 - h24;
            } else {
              i64 h24 = gap_ef(s3, s1, s2, rl, gap);
              i64 h124 = gap_ef(s0 + s1, s3, s2, rl, gap);
              i64 h13 = gap_ef(s0, s2, s1, rl, gap);
              i64 h134 = gap_ef(s0, s2 + s3, s1, rl, gap);
              i64 total = no_gap_ef(s0, s3, s1 + s2, fl);
              eff = total - (h124 - h14 - h24) - (h134 - h14 - h13) - h14;
            }
            w += p * (double)eff / (double)(Lt - fl + 1);
          }
        }
        alpha[(size_t)(b * ni + t)] = w;
      }
    }

    for (i64 b = 0; b < nbins; ++b) P_out.counts.push_back(counts[b]);
    P_out.alpha.insert(P_out.alpha.end(), alpha.begin(), alpha.end());
  }
}

extern "C" {

// ---- standalone disjoint-segs batch (device-prep marshaling input) ------
struct StrawbSegs {
  std::vector<i64> seg_off;  // n_loci+1
  std::vector<i64> seg_l, seg_r;
};

StrawbSegs* strawb_quant_segs_batch(
    i64 n_loci, const i64* iso_loc_off, const i64* iso_idx,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len) {
  auto* S = new StrawbSegs();
  S->seg_off.push_back(0);
  std::vector<i64> ids;
  for (i64 L = 0; L < n_loci; ++L) {
    ids.clear();
    for (i64 q = iso_loc_off[L]; q < iso_loc_off[L + 1]; ++q)
      ids.push_back(iso_idx[q]);
    disjoint_segs(t_off, t_code, t_left, t_len, ids.data(), (i64)ids.size(),
                  S->seg_l, S->seg_r);
    S->seg_off.push_back((i64)S->seg_l.size());
  }
  return S;
}

i64 strawb_segs_n(StrawbSegs* s) { return (i64)s->seg_l.size(); }
const i64* strawb_segs_off(StrawbSegs* s) { return s->seg_off.data(); }
const i64* strawb_segs_l(StrawbSegs* s) { return s->seg_l.data(); }
const i64* strawb_segs_r(StrawbSegs* s) { return s->seg_r.data(); }
void strawb_segs_free(StrawbSegs* s) { delete s; }

// ---- finish batch: bins/counts/weights from device-computed bits --------
// compat_bits: per locus, hit-major x iso-minor 0/1 bytes, concatenated in
// locus order. row_bits: per GLOBAL hit (hit_loc_off indexing), row_bytes
// packed little-endian seg-overlap bits. iso_idx: flat global ref ids.
StrawbQuant* strawb_quant_finish_batch(
    i64 n_loci, const i64* hit_loc_off, const i64* iso_loc_off,
    const i64* iso_idx,
    const i64* h_off, const i8* h_code, const i64* h_left, const i32* h_len,
    const double* h_mass,
    const i64* t_off, const i8* t_code, const i64* t_left, const i32* t_len,
    const i64* t_exlen,
    const uint8_t* compat_bits, const uint8_t* row_bits, i64 row_bytes,
    const double* pdf, i64 pdf_len, i64 read_len, i64 base_lmin,
    i32 long_read) {
  auto* Q = new StrawbQuant();
  Q->bin_off.push_back(0);
  Q->alpha_off.push_back(0);
  std::vector<i64> pair_base(n_loci + 1, 0);
  for (i64 L = 0; L < n_loci; ++L) {
    i64 nh = hit_loc_off[L + 1] - hit_loc_off[L];
    i64 ni = iso_loc_off[L + 1] - iso_loc_off[L];
    pair_base[L + 1] = pair_base[L] + nh * ni;
  }

  auto process_range = [&](i64 L_lo, i64 L_hi, StrawbQuant& P) {
    std::vector<i64> ids;
    QuantLocusOut out;
    for (i64 L = L_lo; L < L_hi; ++L) {
      i64 tbeg = iso_loc_off[L], tend = iso_loc_off[L + 1];
      ids.clear();
      for (i64 q = tbeg; q < tend; ++q) ids.push_back(iso_idx[q]);
      out.counts.clear();
      out.alpha.clear();
      strawb_quant_locus_pre(
          h_off, h_code, h_left, h_len, h_mass,
          hit_loc_off[L], hit_loc_off[L + 1],
          t_off, t_code, t_left, t_len, ids.data(), (i64)ids.size(),
          t_exlen, pdf, pdf_len, read_len, base_lmin, long_read,
          compat_bits + pair_base[L],
          row_bits + hit_loc_off[L] * row_bytes, row_bytes, out);
      P.counts.insert(P.counts.end(), out.counts.begin(), out.counts.end());
      P.alpha.insert(P.alpha.end(), out.alpha.begin(), out.alpha.end());
      P.nbins.push_back((i64)out.counts.size());
    }
  };

  unsigned hw = std::thread::hardware_concurrency();
  size_t TN = hw > 1 ? (hw < 8 ? hw : 8) : 1;
  if (n_loci < 64) TN = 1;
  std::vector<StrawbQuant> parts(TN);
  if (TN == 1) {
    process_range(0, n_loci, parts[0]);
  } else {
    i64 total_h = hit_loc_off[n_loci];
    std::vector<i64> cut(TN + 1, n_loci);
    cut[0] = 0;
    {
      i64 L = 0;
      for (size_t t = 1; t < TN; ++t) {
        i64 want = total_h * (i64)t / (i64)TN;
        while (L < n_loci && hit_loc_off[L] < want) ++L;
        cut[t] = L;
      }
    }
    std::vector<std::thread> pool;
    for (size_t t = 0; t < TN; ++t)
      pool.emplace_back([&, t]() { process_range(cut[t], cut[t + 1],
                                                 parts[t]); });
    for (auto& th : pool) th.join();
  }
  for (size_t t = 0; t < TN; ++t) {
    StrawbQuant& P = parts[t];
    Q->counts.insert(Q->counts.end(), P.counts.begin(), P.counts.end());
    Q->alpha.insert(Q->alpha.end(), P.alpha.begin(), P.alpha.end());
    i64 Lbase = (i64)Q->nbins.size();
    for (size_t k = 0; k < P.nbins.size(); ++k) {
      i64 ni = iso_loc_off[Lbase + (i64)k + 1] - iso_loc_off[Lbase + (i64)k];
      Q->bin_off.push_back(Q->bin_off.back() + P.nbins[k]);
      Q->alpha_off.push_back(Q->alpha_off.back() + P.nbins[k] * ni);
      Q->nbins.push_back(P.nbins[k]);
    }
  }
  return Q;
}

// ---- test surface: the n>=5 effective-length oracle vs closed form ------
i64 strawb_efflen_enum(const i64* s, i64 n, const i64* implicit, i64 nimp,
                       i64 fl, i64 rl) {
  std::vector<i64> vs(s, s + n), vi(implicit, implicit + nimp);
  return effective_len_n5_enum(vs, vi, fl, rl);
}

i64 strawb_efflen(const i64* s, i64 n, const i64* implicit, i64 nimp,
                  i64 fl, i64 rl) {
  std::vector<i64> vs(s, s + n), vi(implicit, implicit + nimp);
  return effective_len(vs, vi, fl, rl);
}

const i64* strawb_quant_nbins(StrawbQuant* q) { return q->nbins.data(); }
const i64* strawb_quant_binoff(StrawbQuant* q) { return q->bin_off.data(); }
const double* strawb_quant_counts(StrawbQuant* q) { return q->counts.data(); }
const i64* strawb_quant_alphaoff(StrawbQuant* q) { return q->alpha_off.data(); }
const double* strawb_quant_alpha(StrawbQuant* q) { return q->alpha.data(); }
i64 strawb_quant_total_bins(StrawbQuant* q) { return (i64)q->counts.size(); }
i64 strawb_quant_total_alpha(StrawbQuant* q) { return (i64)q->alpha.size(); }
void strawb_quant_free(StrawbQuant* q) { delete q; }

}  // extern "C"
