// Symbolic analysis of a sparse symmetric LDL^T over a variable graph.
//
// Used by dcora_tpu_torch.core.ldlt: the certificate S's inertia proof
// factors S + tI on the card for many shifts t, all of one pattern, so the
// pattern is analysed once here:
//
//   1. a fill-reducing ordering of the variable graph (one node per pose,
//      sphere or landmark; a node stands for its 1..d+1 scalar columns):
//      approximate minimum degree on the quotient graph (Amestoy, Davis and
//      Duff, SIAM J. Matrix Anal. Appl. 17(4), 1996), in the compact form
//      of T. A. Davis, "Direct Methods for Sparse Linear Systems" (SIAM
//      2006), Sec. 7.1;
//   2. the elimination tree of the ordered graph and its postorder;
//   3. each node's row structure in L (children's structures merged into
//      their parent's), hence the column counts;
//   4. fundamental supernodes, then relaxed amalgamation of a supernode into
//      its parent while the explicit zeros it adds stay few (counted in
//      scalar columns, from the node weights);
//   5. the supernodal tree's parents and level (height above the leaves),
//      and each supernode's row structure below its columns;
//   6. (dcora_ldlt_place) the fronts' offsets in one buffer, first fit by
//      lifetime.
//
// Everything is in node units; the caller expands nodes to their scalar
// columns.  The C ABI (declared here, not in dcora_native.h, which is the
// JAX package's header): dcora_ldlt_analyse returns a handle (NULL on
// failure, with a message in errbuf), dcora_ldlt_sizes and dcora_ldlt_get
// copy its arrays out, dcora_ldlt_free releases it; dcora_ldlt_place
// places the caller's groups of fronts.  All index arrays are int64.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <new>
#include <vector>

namespace {

using idx = int64_t;

inline idx flip(idx i) { return -i - 2; }

idx wclear(idx mark, idx lemax, idx *w, idx n) {
  if (mark < 2 || mark + lemax < 0) {
    for (idx k = 0; k < n; k++)
      if (w[k] != 0) w[k] = 1;
    mark = 2;
  }
  return mark;  // w[0..n-1] < mark holds from here
}

// depth-first search of the tree in head/next from root j, writing the
// postorder into post from position k; returns the next position
idx tdfs(idx j, idx k, idx *head, const idx *next, idx *post, idx *stack) {
  idx top = 0;
  stack[0] = j;
  while (top >= 0) {
    idx p = stack[top];
    idx i = head[p];
    if (i == -1) {
      top--;
      post[k++] = p;
    } else {
      head[p] = next[i];
      stack[++top] = i;
    }
  }
  return k;
}

// Approximate minimum degree ordering of the symmetric pattern (ap, ai)
// (n nodes, no diagonal entries).  Returns P with P[k] = the node
// eliminated k-th.
std::vector<idx> amd(idx n, const idx *ap, const idx *ai) {
  const idx cnz0 = ap[n];
  idx dense = std::max<idx>(16, (idx)(10 * std::sqrt((double)n)));
  dense = std::min<idx>(n - 2, dense);
  idx nzmax = cnz0 + cnz0 / 5 + 2 * n;
  std::vector<idx> Cpv(n + 1), Civ(std::max<idx>(nzmax, 1));
  std::copy(ap, ap + n + 1, Cpv.begin());
  std::copy(ai, ai + cnz0, Civ.begin());
  idx *Cp = Cpv.data(), *Ci = Civ.data();
  idx cnz = cnz0;
  std::vector<idx> Pv(n + 1), Wv(8 * (n + 1));
  idx *P = Pv.data(), *W = Wv.data();
  idx *len = W, *nv = W + (n + 1), *next = W + 2 * (n + 1),
      *head = W + 3 * (n + 1), *elen = W + 4 * (n + 1),
      *degree = W + 5 * (n + 1), *w = W + 6 * (n + 1),
      *hhead = W + 7 * (n + 1);
  idx *last = P;  // P is workspace until the postorder
  idx lemax = 0, mindeg = 0, nel = 0;

  for (idx k = 0; k < n; k++) len[k] = Cp[k + 1] - Cp[k];
  len[n] = 0;
  for (idx i = 0; i <= n; i++) {
    head[i] = -1;
    last[i] = -1;
    next[i] = -1;
    hhead[i] = -1;
    nv[i] = 1;
    w[i] = 1;
    elen[i] = 0;
    degree[i] = len[i];
  }
  idx mark = wclear(0, 0, w, n);
  elen[n] = -2;  // n is a dead element, root of the dense nodes
  Cp[n] = -1;
  w[n] = 0;
  for (idx i = 0; i < n; i++) {
    idx d = degree[i];
    if (d == 0) {  // empty node: an element at once
      elen[i] = -2;
      nel++;
      Cp[i] = -1;
      w[i] = 0;
    } else if (d > dense) {  // dense node: absorbed into element n
      nv[i] = 0;
      elen[i] = -1;
      nel++;
      Cp[i] = flip(n);
      nv[n]++;
    } else {
      if (head[d] != -1) last[head[d]] = i;
      next[i] = head[d];
      head[d] = i;
    }
  }
  while (nel < n) {
    // node k of least approximate degree
    idx k = -1;
    for (; mindeg < n && (k = head[mindeg]) == -1; mindeg++) {
    }
    if (next[k] != -1) last[next[k]] = -1;
    head[mindeg] = next[k];
    idx elenk = elen[k], nvk = nv[k];
    nel += nvk;
    // garbage collection
    if (elenk > 0 && cnz + mindeg >= nzmax) {
      for (idx j = 0; j < n; j++) {
        idx p = Cp[j];
        if (p >= 0) {
          Cp[j] = Ci[p];
          Ci[p] = flip(j);
        }
      }
      idx q = 0;
      for (idx p = 0; p < cnz;) {
        idx j = flip(Ci[p++]);
        if (j >= 0) {
          Ci[q] = Cp[j];
          Cp[j] = q++;
          for (idx k3 = 0; k3 < len[j] - 1; k3++) Ci[q++] = Ci[p++];
        }
      }
      cnz = q;
    }
    // the new element Lk
    idx dk = 0;
    nv[k] = -nvk;
    idx p = Cp[k];
    idx pk1 = (elenk == 0) ? p : cnz;
    idx pk2 = pk1;
    for (idx k1 = 1; k1 <= elenk + 1; k1++) {
      idx e, pj, ln;
      if (k1 > elenk) {
        e = k;
        pj = p;
        ln = len[k] - elenk;
      } else {
        e = Ci[p++];
        pj = Cp[e];
        ln = len[e];
      }
      for (idx k2 = 1; k2 <= ln; k2++) {
        idx i = Ci[pj++];
        idx nvi = nv[i];
        if (nvi <= 0) continue;
        dk += nvi;
        nv[i] = -nvi;
        Ci[pk2++] = i;
        if (next[i] != -1) last[next[i]] = last[i];
        if (last[i] != -1)
          next[last[i]] = next[i];
        else
          head[degree[i]] = next[i];
      }
      if (e != k) {
        Cp[e] = flip(k);
        w[e] = 0;
      }
    }
    if (elenk != 0) cnz = pk2;
    degree[k] = dk;
    Cp[k] = pk1;
    len[k] = pk2 - pk1;
    elen[k] = -2;
    // set differences |Le \ Lk|
    mark = wclear(mark, lemax, w, n);
    for (idx pk = pk1; pk < pk2; pk++) {
      idx i = Ci[pk];
      idx eln = elen[i];
      if (eln <= 0) continue;
      idx nvi = -nv[i];
      idx wnvi = mark - nvi;
      for (idx q = Cp[i]; q <= Cp[i] + eln - 1; q++) {
        idx e = Ci[q];
        if (w[e] >= mark)
          w[e] -= nvi;
        else if (w[e] != 0)
          w[e] = degree[e] + wnvi;
      }
    }
    // degree update
    for (idx pk = pk1; pk < pk2; pk++) {
      idx i = Ci[pk];
      idx p1 = Cp[i];
      idx p2 = p1 + elen[i] - 1;
      idx pn = p1;
      idx h = 0, d = 0;
      for (idx q = p1; q <= p2; q++) {
        idx e = Ci[q];
        if (w[e] != 0) {
          idx dext = w[e] - mark;
          if (dext > 0) {
            d += dext;
            Ci[pn++] = e;
            h += e;
          } else {  // aggressive absorption
            Cp[e] = flip(k);
            w[e] = 0;
          }
        }
      }
      elen[i] = pn - p1 + 1;
      idx p3 = pn;
      idx p4 = p1 + len[i];
      for (idx q = p2 + 1; q < p4; q++) {
        idx j = Ci[q];
        idx nvj = nv[j];
        if (nvj <= 0) continue;
        d += nvj;
        Ci[pn++] = j;
        h += j;
      }
      if (d == 0) {  // mass elimination
        Cp[i] = flip(k);
        idx nvi = -nv[i];
        dk -= nvi;
        nvk += nvi;
        nel += nvi;
        nv[i] = 0;
        elen[i] = -1;
      } else {
        degree[i] = std::min(degree[i], d);
        Ci[pn] = Ci[p3];
        Ci[p3] = Ci[p1];
        Ci[p1] = k;
        len[i] = pn - p1 + 1;
        h = ((h < 0) ? -h : h) % n;
        next[i] = hhead[h];
        hhead[h] = i;
        last[i] = h;
      }
    }
    degree[k] = dk;
    lemax = std::max(lemax, dk);
    mark = wclear(mark + lemax, lemax, w, n);
    // supervariable detection
    for (idx pk = pk1; pk < pk2; pk++) {
      idx i = Ci[pk];
      if (nv[i] >= 0) continue;
      idx h = last[i];
      i = hhead[h];
      hhead[h] = -1;
      for (; i != -1 && next[i] != -1; i = next[i], mark++) {
        idx ln = len[i], eln = elen[i];
        for (idx q = Cp[i] + 1; q <= Cp[i] + ln - 1; q++) w[Ci[q]] = mark;
        idx jlast = i;
        for (idx j = next[i]; j != -1;) {
          bool ok = (len[j] == ln) && (elen[j] == eln);
          for (idx q = Cp[j] + 1; ok && q <= Cp[j] + ln - 1; q++)
            if (w[Ci[q]] != mark) ok = false;
          if (ok) {
            Cp[j] = flip(i);
            nv[i] += nv[j];
            nv[j] = 0;
            elen[j] = -1;
            j = next[j];
            next[jlast] = j;
          } else {
            jlast = j;
            j = next[j];
          }
        }
      }
    }
    // finalize Lk
    idx pf = pk1;
    for (idx pk = pk1; pk < pk2; pk++) {
      idx i = Ci[pk];
      idx nvi = -nv[i];
      if (nvi <= 0) continue;
      nv[i] = nvi;
      idx d = degree[i] + dk - nvi;
      d = std::min(d, n - nel - nvi);
      if (head[d] != -1) last[head[d]] = i;
      next[i] = head[d];
      last[i] = -1;
      head[d] = i;
      mindeg = std::min(mindeg, d);
      degree[i] = d;
      Ci[pf++] = i;
    }
    nv[k] = nvk;
    if ((len[k] = pf - pk1) == 0) {
      Cp[k] = -1;
      w[k] = 0;
    }
    if (elenk != 0) cnz = pf;
  }
  // postorder the assembly tree
  for (idx i = 0; i < n; i++) Cp[i] = flip(Cp[i]);
  for (idx j = 0; j <= n; j++) head[j] = -1;
  for (idx j = n; j >= 0; j--) {
    if (nv[j] > 0) continue;
    next[j] = head[Cp[j]];
    head[Cp[j]] = j;
  }
  for (idx e = n; e >= 0; e--) {
    if (nv[e] <= 0) continue;
    if (Cp[e] != -1) {
      next[e] = head[Cp[e]];
      head[Cp[e]] = e;
    }
  }
  for (idx k = 0, i = 0; i <= n; i++)
    if (Cp[i] == -1) k = tdfs(i, k, head, next, P, w);
  Pv.resize(n);  // P[n] == n, the dense nodes' root
  return Pv;
}

struct Analysis {
  std::vector<idx> perm;       // [nn] node eliminated at each position
  std::vector<idx> sn_ptr;     // [ns + 1] supernodes' node positions
  std::vector<idx> sn_parent;  // [ns] -1 at a root
  std::vector<idx> sn_level;   // [ns] 0 at a leaf, 1 + the children's most
  std::vector<idx> rs_ptr;     // [ns + 1]
  std::vector<idx> rs_idx;     // node positions below each supernode
};

// Relaxed amalgamation (CHOLMOD's rule, in scalar columns): a supernode
// joins its parent when the merged one has at most RELAX[0] columns, or at
// most RELAX[q] columns and a share of explicit zeros below ZRELAX[q].
constexpr idx RELAX[3] = {16, 64, 192};
constexpr double ZRELAX[3] = {0.8, 0.1, 0.05};

Analysis analyse(idx nn, const idx *ap, const idx *ai, const idx *weight) {
  Analysis A;
  std::vector<idx> P = amd(nn, ap, ai);
  std::vector<idx> pinv(nn);
  for (idx k = 0; k < nn; k++) pinv[P[k]] = k;

  // elimination tree of the ordered graph
  std::vector<idx> parent(nn, -1), ancestor(nn, -1);
  for (idx k = 0; k < nn; k++) {
    idx v = P[k];
    for (idx q = ap[v]; q < ap[v + 1]; q++) {
      idx i = pinv[ai[q]];
      while (i != -1 && i < k) {
        idx inext = ancestor[i];
        ancestor[i] = k;
        if (inext == -1) parent[i] = k;
        i = inext;
      }
    }
  }
  // its postorder, composed with the ordering
  std::vector<idx> head(nn, -1), next(nn, -1), stack(nn), post(nn);
  for (idx j = nn - 1; j >= 0; j--)
    if (parent[j] != -1) {
      next[j] = head[parent[j]];
      head[parent[j]] = j;
    }
  for (idx k = 0, j = 0; j < nn; j++)
    if (parent[j] == -1) k = tdfs(j, k, head.data(), next.data(),
                                  post.data(), stack.data());
  std::vector<idx> ipost(nn);
  for (idx k = 0; k < nn; k++) ipost[post[k]] = k;
  A.perm.resize(nn);
  std::vector<idx> par(nn);
  for (idx k = 0; k < nn; k++) {
    A.perm[k] = P[post[k]];
    idx pa = parent[post[k]];
    par[k] = pa < 0 ? -1 : ipost[pa];
  }
  for (idx k = 0; k < nn; k++) pinv[A.perm[k]] = k;

  // row structure of each node's column of L: its graph neighbours after
  // it, and its children's structures without itself
  std::vector<idx> nchild(nn, 0);
  for (idx k = 0; k < nn; k++)
    if (par[k] >= 0) nchild[par[k]]++;
  std::vector<idx> cptr(nn + 1, 0), clist(nn);
  for (idx k = 0; k < nn; k++) cptr[k + 1] = cptr[k] + nchild[k];
  {
    std::vector<idx> fill(cptr.begin(), cptr.end() - 1);
    for (idx k = 0; k < nn; k++)
      if (par[k] >= 0) clist[fill[par[k]]++] = k;
  }
  std::vector<idx> sptr(nn + 1, 0), sidx;
  sidx.reserve(4 * (size_t)ap[nn] + 16);
  std::vector<idx> marker(nn, -1);
  for (idx k = 0; k < nn; k++) {
    marker[k] = k;
    idx v = A.perm[k];
    for (idx q = ap[v]; q < ap[v + 1]; q++) {
      idx i = pinv[ai[q]];
      if (i > k && marker[i] != k) {
        marker[i] = k;
        sidx.push_back(i);
      }
    }
    for (idx c = cptr[k]; c < cptr[k + 1]; c++) {
      idx ch = clist[c];
      for (idx q = sptr[ch]; q < sptr[ch + 1]; q++) {
        idx i = sidx[q];
        if (marker[i] != k) {
          marker[i] = k;
          sidx.push_back(i);
        }
      }
    }
    sptr[k + 1] = (idx)sidx.size();
  }
  auto cnt = [&](idx k) { return sptr[k + 1] - sptr[k]; };

  // fundamental supernodes
  std::vector<idx> first;  // first node of each supernode
  for (idx k = 0; k < nn; k++)
    if (!(k > 0 && par[k - 1] == k && nchild[k] == 1 &&
          cnt(k - 1) == cnt(k) + 1))
      first.push_back(k);
  idx ns0 = (idx)first.size();
  first.push_back(nn);
  std::vector<idx> wcol(nn + 1, 0);  // scalar column prefix over positions
  for (idx k = 0; k < nn; k++) wcol[k + 1] = wcol[k] + weight[A.perm[k]];
  auto scalar_rows = [&](idx k) {  // scalar rows below node k's column
    idx m = 0;
    for (idx q = sptr[k]; q < sptr[k + 1]; q++) m += weight[A.perm[sidx[q]]];
    return m;
  };
  std::vector<idx> sn_of(nn);
  for (idx s = 0; s < ns0; s++)
    for (idx k = first[s]; k < first[s + 1]; k++) sn_of[k] = s;

  // relaxed amalgamation, leaves first: s joins its parent p when s is
  // p's last child (its columns right before p's)
  std::vector<idx> a(ns0), b(ns0), m(ns0), z(ns0, 0);
  std::vector<char> alive(ns0, 1);
  for (idx s = 0; s < ns0; s++) {
    a[s] = first[s];
    b[s] = first[s + 1] - 1;
    m[s] = scalar_rows(b[s]);
  }
  auto trap = [](idx w, idx mm) { return w * (w + 1) / 2 + w * mm; };
  for (idx s = 0; s < ns0; s++) {
    idx pk = par[b[s]];
    if (pk < 0) continue;
    idx p = sn_of[pk];
    if (b[s] + 1 != a[p]) continue;
    idx ws = wcol[b[s] + 1] - wcol[a[s]], wp = wcol[b[p] + 1] - wcol[a[p]];
    idx nc = ws + wp;
    idx nzm = trap(nc, m[p]);
    idx zm = nzm - (trap(ws, m[s]) - z[s]) - (trap(wp, m[p]) - z[p]);
    double frac = nzm > 0 ? (double)zm / (double)nzm : 0.0;
    bool merge = nc <= RELAX[0] || (nc <= RELAX[1] && frac < ZRELAX[0]) ||
                 (nc <= RELAX[2] && frac < ZRELAX[1]) || frac < ZRELAX[2];
    if (!merge) continue;
    a[p] = a[s];
    z[p] = zm;
    alive[s] = 0;
  }
  std::vector<idx> sn_final(ns0, -1);
  idx ns = 0;
  A.sn_ptr.push_back(0);
  for (idx s = 0; s < ns0; s++)
    if (alive[s]) {
      A.sn_ptr.push_back(b[s] + 1);
      sn_final[s] = ns++;
    }
  std::vector<idx> sn_of_node(nn);
  for (idx s = 0; s < ns; s++)
    for (idx k = A.sn_ptr[s]; k < A.sn_ptr[s + 1]; k++) sn_of_node[k] = s;
  A.sn_parent.assign(ns, -1);
  A.sn_level.assign(ns, 0);
  A.rs_ptr.assign(ns + 1, 0);
  for (idx s = 0; s < ns; s++) {
    idx last = A.sn_ptr[s + 1] - 1;
    std::vector<idx> rows(sidx.begin() + sptr[last],
                          sidx.begin() + sptr[last + 1]);
    std::sort(rows.begin(), rows.end());
    A.rs_idx.insert(A.rs_idx.end(), rows.begin(), rows.end());
    A.rs_ptr[s + 1] = (idx)A.rs_idx.size();
    if (!rows.empty()) A.sn_parent[s] = sn_of_node[rows[0]];
  }
  for (idx s = 0; s < ns; s++)  // children precede parents
    if (A.sn_parent[s] >= 0)
      A.sn_level[A.sn_parent[s]] =
          std::max(A.sn_level[A.sn_parent[s]], A.sn_level[s] + 1);
  return A;
}

}  // namespace

extern "C" {

void *dcora_ldlt_analyse(int64_t nn, const int64_t *adj_ptr,
                         const int64_t *adj_idx, const int64_t *weight,
                         char *errbuf, int errlen) {
  try {
    return new Analysis(analyse(nn, adj_ptr, adj_idx, weight));
  } catch (const std::bad_alloc &) {
    if (errbuf && errlen > 0)
      std::snprintf(errbuf, (size_t)errlen, "LDL^T analysis: out of memory");
    return nullptr;
  }
}

// out: number of supernodes, length of the row structures' index array
void dcora_ldlt_sizes(const void *h, int64_t *out) {
  const Analysis *A = static_cast<const Analysis *>(h);
  out[0] = (int64_t)A->sn_parent.size();
  out[1] = (int64_t)A->rs_idx.size();
}

void dcora_ldlt_get(const void *h, int64_t *perm, int64_t *sn_ptr,
                    int64_t *sn_parent, int64_t *sn_level, int64_t *rs_ptr,
                    int64_t *rs_idx) {
  const Analysis *A = static_cast<const Analysis *>(h);
  std::copy(A->perm.begin(), A->perm.end(), perm);
  std::copy(A->sn_ptr.begin(), A->sn_ptr.end(), sn_ptr);
  std::copy(A->sn_parent.begin(), A->sn_parent.end(), sn_parent);
  std::copy(A->sn_level.begin(), A->sn_level.end(), sn_level);
  std::copy(A->rs_ptr.begin(), A->rs_ptr.end(), rs_ptr);
  std::copy(A->rs_idx.begin(), A->rs_idx.end(), rs_idx);
}

void dcora_ldlt_free(void *h) { delete static_cast<Analysis *>(h); }

// Offsets of ng groups of fronts in one buffer: group g holds gsize[g]
// words from level gfrom[g] to level guntil[g], both included.  The groups
// are placed in `order` (gfrom ascending), each at the lowest offset where
// it overlaps no placed group whose life overlaps its own (first fit; a
// sweep over the levels keeps the groups still alive, ordered by offset).
// Returns 0, or -1 when `order` is not ascending in gfrom.
int dcora_ldlt_place(int64_t ng, const int64_t *order, const int64_t *gsize,
                     const int64_t *gfrom, const int64_t *guntil,
                     int64_t *goff) {
  struct Placed {
    idx lo, hi, until;
  };
  std::vector<Placed> alive, kept;
  idx level = 0;
  for (idx q = 0; q < ng; q++) {
    const idx g = order[q];
    if (gfrom[g] < level) return -1;
    level = gfrom[g];
    kept.clear();
    for (const Placed &a : alive)
      if (a.until >= level) kept.push_back(a);
    alive.swap(kept);
    idx at = 0, i = 0;
    for (; i < (idx)alive.size(); i++) {
      if (at + gsize[g] <= alive[i].lo) break;
      at = std::max(at, alive[i].hi);
    }
    goff[g] = at;
    // alive stays ordered by offset: every group before i starts below at
    while (i < (idx)alive.size() && alive[i].lo < at) i++;
    alive.insert(alive.begin() + i, Placed{at, at + gsize[g], guntil[g]});
  }
  return 0;
}

}  // extern "C"
