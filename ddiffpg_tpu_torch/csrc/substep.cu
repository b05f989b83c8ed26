// Fused rigid-body substep, one thread per env.
//
// Replaces ddiffpg_tpu/physics/pallas_ant.py:make_substep_kernel (the Pallas
// TPU kernel launched at pallas_ant.py:789) for its whole model class: FREE
// roots, HINGE/SLIDE/FIXED joints anchored at the body origin with several
// roots allowed, torque motors and gravity-compensated PD position servos,
// sphere/capsule probes against the ground plane, static AABBs and dynamic
// (body-attached) OBBs. It computes what that kernel's substep_math
// computes, in the same stage order and with the same summation order as
// the plain PyTorch version in physics/substep.py:
//   FK -> robot-centred frame -> motion subspaces and body velocities ->
//   6x6 inertias -> probe contacts vs plane and static AABBs (separation
//   gate, impulse cap) -> per-body impulse and global thrust budgets ->
//   dynamic OBBs with their reaction on the box body (stage g) ->
//   RNEA bias -> servo gravity compensation -> CRBA -> servos, motors,
//   damping, limit springs -> Cholesky solve -> semi-implicit integration
//   with clamps and inelastic limit stops.
// physics/substep.py:check_supported guards the class.
//
// What bounds it on the card: latency of a long dependent chain of scalar
// fp32 work per env (1.1e4 to 7.1e4 elementwise ops per substep, Panda
// Reach to the ant), with per-env state far above the register file
// (inertias, mass matrix), so much of it lives in local memory (L1/L2) and
// the kernel accepts that: ptxas gives the ant 223 registers and a
// 4640-byte stack frame a thread, DrawerMulti 166 and 5664 bytes (no
// spills), and at 4096 envs the launch is 128 warps for 132 SMs. Global
// memory is read once and written once per launch. The work's bound is
// set by operations; PERF.md holds the times against it.
// Design: one walk of the joint tree serves every model (for the ant it
// costs ~2% against a walk that hard-codes its tree, on an H100; PERF.md);
// sizes and the Panda-only stages are compile-time defines (-DNB ...
// -DNSUB, -DHAS_SERVO, -DNDB), so the ant's build compiles no servo and no
// dynamic-box code, and the loops over bodies branch on joint types read
// from __constant__ memory, the same for every thread of a warp; model
// arrays sit in __constant__ memory, uploaded once when the library is
// loaded; threads with env >= B return, so any batch size runs (no tile
// padding).
//
// Numerics: every literal carries an f suffix (no fp64 promotion); built
// without --use_fast_math and with -fmad=false, so each a*b+c rounds twice
// as in the plain version. min/max propagate NaN like torch/jnp so broken
// states stay non-finite.

#include <cuda_runtime.h>
#include <math.h>

#if !defined(NB) || !defined(NV) || !defined(NQ) || !defined(NU) || \
    !defined(NPR) || !defined(NSB) || !defined(NDB) || !defined(NSUB) || \
    !defined(HAS_SERVO)
#error "NB, NV, NQ, NU, NPR, NSB, NDB, NSUB and HAS_SERVO must be defined"
#endif
#define NSB_ALLOC (NSB > 0 ? NSB : 1)
#define NDB_ALLOC (NDB > 0 ? NDB : 1)
#define NLT (NV * (NV + 1) / 2)

enum { J_FREE = 0, J_HINGE = 1, J_SLIDE = 2, J_FIXED = 3 };

// All members are 4 bytes wide, so the layout has no padding; the ctypes
// mirror in physics/substep_cuda.py lists the same fields in this order.
struct SubstepModel {
  int parent[NB];
  int jnt_type[NB];
  int qposadr[NB];
  int dofadr[NB];
  int ident_quat[NB];
  int anc_mask[NB];
  float axis[NB][3];
  float body_pos[NB][3];
  float body_quat[NB][4];
  float mass[NB];
  float com[NB][3];
  float inertia[NB][3][3];
  float damping[NV];
  float armature[NV];
  float lim_lo[NV];
  float lim_hi[NV];
  int lim_on[NV];
  int dof_body[NV];
  int act_dof[NU];
  float act_gear[NU];
  int act_type[NU];
  float act_kp[NU];
  float act_kd[NU];
  float act_force[NU];
  int act_qadr[NU];
  int probe_body[NPR];
  float probe_off[NPR][3];
  float probe_rad[NPR];
  float probe_fric[NPR];
  float probe_kn[NPR];
  float probe_cn[NPR];
  float box_min[NSB_ALLOC][3];
  float box_max[NSB_ALLOC][3];
  int dbox_body[NDB_ALLOC];
  int dbox_ident[NDB_ALLOC];
  float dbox_pos[NDB_ALLOC][3];
  float dbox_quat[NDB_ALLOC][4];
  float dbox_half[NDB_ALLOC][3];
  float dbox_keep[NDB_ALLOC][NPR];  // 0 for the box body's own probes
  float gravity[3];
  float dt, inv_nb, capk_scale, inv_vreb, vreb, vtol, vtol_eps, lim_k, lim_c,
      vmax, support_f, m_total, inv_m_total;
};

__constant__ SubstepModel c_m;

struct V3 {
  float x, y, z;
};
struct Q4 {
  float w, x, y, z;
};
struct SV {  // spatial vector: angular, linear
  V3 a, l;
};

__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || a != a) ? a : b;  // NaN-propagating, like torch.maximum
}
__device__ __forceinline__ float minp(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float clipp(float x, float lo, float hi) {
  return minp(maxp(x, lo), hi);
}

__device__ __forceinline__ V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
__device__ __forceinline__ V3 ld3(const float* p) { return mk(p[0], p[1], p[2]); }
__device__ __forceinline__ Q4 ldq(const float* p) {
  Q4 r;
  r.w = p[0];
  r.x = p[1];
  r.y = p[2];
  r.z = p[3];
  return r;
}
__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V3 vscale(V3 a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
  Q4 r;
  r.w = a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z;
  r.x = a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y;
  r.y = a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x;
  r.z = a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w;
  return r;
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
  V3 qv = mk(q.x, q.y, q.z);
  V3 t = vscale(vcross(qv, v), 2.0f);
  return vadd(vadd(v, vscale(t, q.w)), vcross(qv, t));
}
__device__ __forceinline__ SV sv_add(SV a, SV b) {
  SV r;
  r.a = vadd(a.a, b.a);
  r.l = vadd(a.l, b.l);
  return r;
}
__device__ __forceinline__ SV sv_scale(SV a, float s) {
  SV r;
  r.a = vscale(a.a, s);
  r.l = vscale(a.l, s);
  return r;
}
__device__ __forceinline__ SV cross_motion(SV v, SV m) {
  SV r;
  r.a = vcross(v.a, m.a);
  r.l = vadd(vcross(v.a, m.l), vcross(v.l, m.a));
  return r;
}
__device__ __forceinline__ SV cross_force(SV v, SV f) {
  SV r;
  r.a = vadd(vcross(v.a, f.a), vcross(v.l, f.l));
  r.l = vcross(v.a, f.l);
  return r;
}
__device__ __forceinline__ SV i6vec(const float blk[6][6], SV s) {
  const float a[6] = {s.a.x, s.a.y, s.a.z, s.l.x, s.l.y, s.l.z};
  float o[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float acc = blk[r][0] * a[0];
#pragma unroll
    for (int c = 1; c < 6; ++c) acc = acc + blk[r][c] * a[c];
    o[r] = acc;
  }
  SV out;
  out.a = mk(o[0], o[1], o[2]);
  out.l = mk(o[3], o[4], o[5]);
  return out;
}

// Penalty normal force with separation gate and impulse cap, regularised
// Coulomb friction on the (relative) velocity v (pallas_ant.py:387-406,
// 545-560). Returns the force; f_n is the normal impulse rate.
__device__ __forceinline__ V3 penalty_force(float dist, V3 n, V3 v, float kn,
                                            float cn, float fric, float& f_n,
                                            float& pen) {
  pen = maxp(-dist, 0.0f);
  const float v_n = v.x * n.x + v.y * n.y + v.z * n.z;
  f_n = maxp(kn * pen - cn * v_n, 0.0f);
  f_n = pen > 0.0f ? f_n : 0.0f;
  f_n = f_n * clipp(1.0f - v_n * c_m.inv_vreb, 0.0f, 1.0f);
  const float cap_k = kn * c_m.capk_scale;
  f_n = minp(f_n, maxp(cap_k * (c_m.vreb - v_n), 0.0f));
  const float tx = v.x - v_n * n.x;
  const float ty = v.y - v_n * n.y;
  const float tz = v.z - v_n * n.z;
  const float vt = sqrtf(tx * tx + ty * ty + tz * tz + c_m.vtol_eps);
  const float scale = minp(vt / c_m.vtol, 1.0f);
  const float ft = -fric * f_n * scale / vt;
  return mk(f_n * n.x + ft * tx, f_n * n.y + ft * ty, f_n * n.z + ft * tz);
}

struct Contact {
  float fx, fy, fz, fn, vn_body;
};

// World contact: also the body's normal velocity for the impulse budget.
__device__ __forceinline__ Contact contact_force(float dist, V3 n, V3 v, V3 vb,
                                                 float kn, float cn,
                                                 float fric) {
  float f_n, pen;
  const V3 f = penalty_force(dist, n, v, kn, cn, fric, f_n, pen);
  const float v_cn = vb.x * n.x + vb.y * n.y + vb.z * n.z;
  Contact r;
  r.fx = f.x;
  r.fy = f.y;
  r.fz = f.z;
  r.fn = f_n;
  r.vn_body = pen > 0.0f ? v_cn : 1e9f;  // sentinel: not in contact
  return r;
}

// Nearest face of a box from its six face distances (-x, +x, -y, +y, -z,
// +z), first in face order on ties: returns the distance, sets the normal.
__device__ __forceinline__ float nearest_face(const float fl[6], float ni[3]) {
  float d_in = fl[0];
#pragma unroll
  for (int f = 1; f < 6; ++f) d_in = minp(d_in, fl[f]);
  ni[0] = ni[1] = ni[2] = 0.0f;
  bool chosen = false;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const bool hit = (fl[f] <= d_in) && !chosen;
    if (hit) {
      ni[0] = ni[1] = ni[2] = 0.0f;
      ni[f >> 1] = (f & 1) ? 1.0f : -1.0f;
    }
    chosen = chosen || hit;
  }
  return d_in;
}

__device__ __forceinline__ int dof_body(int d) { return c_m.dof_body[d]; }
__device__ __forceinline__ bool one_dof(int t) {
  return t == J_HINGE || t == J_SLIDE;
}
__device__ __forceinline__ int lt(int i, int j) { return i * (i + 1) / 2 + j; }

__device__ void substep(float q[NQ], float qd[NV], const float ctrl[NU]) {
  const float dt = c_m.dt;

  // ---------------- FK: FREE roots; HINGE, SLIDE, FIXED anywhere; other
  // roots keep their constant frame
  V3 pos[NB];
  Q4 quat[NB];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int t = c_m.jnt_type[i], qa = c_m.qposadr[i];
    if (t == J_FREE) {
      pos[i] = mk(q[qa], q[qa + 1], q[qa + 2]);
      quat[i] = ldq(q + qa + 3);
      continue;
    }
    const int p = c_m.parent[i];
    V3 p0;
    Q4 q0;
    if (p >= 0) {
      p0 = vadd(pos[p], qrot(quat[p], ld3(c_m.body_pos[i])));
      q0 = quat[p];
      if (!c_m.ident_quat[i]) q0 = qmul(quat[p], ldq(c_m.body_quat[i]));
    } else {
      p0 = ld3(c_m.body_pos[i]);
      q0 = ldq(c_m.body_quat[i]);
    }
    if (t == J_HINGE) {
      const float half = q[qa] * 0.5f;
      const float s = sinf(half);
      Q4 qj;
      qj.w = cosf(half);
      qj.x = c_m.axis[i][0] * s;
      qj.y = c_m.axis[i][1] * s;
      qj.z = c_m.axis[i][2] * s;
      quat[i] = qmul(q0, qj);
      pos[i] = p0;
    } else if (t == J_SLIDE) {
      pos[i] = vadd(p0, vscale(qrot(q0, ld3(c_m.axis[i])), q[qa]));
      quat[i] = q0;
    } else {  // FIXED
      pos[i] = p0;
      quat[i] = q0;
    }
  }

  // ---------------- robot-centred frame about the body centroid
  V3 c0 = pos[0];
  for (int i = 1; i < NB; ++i) c0 = vadd(c0, pos[i]);
  const V3 p0 = vscale(c0, c_m.inv_nb);
  V3 posr[NB];
  for (int i = 0; i < NB; ++i) posr[i] = vsub(pos[i], p0);

  // ---------------- motion subspaces, qvel -> u, body spatial velocities
  SV S[NV];
  float u[NV];
  for (int d = 0; d < NV; ++d) u[d] = qd[d];
  SV V[NB];
  const V3 zero3 = mk(0.0f, 0.0f, 0.0f);
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int t = c_m.jnt_type[i], d = c_m.dofadr[i], p = c_m.parent[i];
    SV base;
    if (p >= 0) {
      base = V[p];
    } else {
      base.a = zero3;
      base.l = zero3;
    }
    if (t == J_FREE) {
      for (int k = 0; k < 3; ++k) {
        float e[3] = {0.0f, 0.0f, 0.0f};
        e[k] = 1.0f;
        S[d + k].a = zero3;
        S[d + k].l = mk(e[0], e[1], e[2]);
        S[d + 3 + k].a = mk(e[0], e[1], e[2]);
        S[d + 3 + k].l = zero3;
      }
      const V3 vo = vsub(mk(qd[d], qd[d + 1], qd[d + 2]),
                         vcross(mk(qd[d + 3], qd[d + 4], qd[d + 5]),
                                posr[i]));
      u[d] = vo.x;
      u[d + 1] = vo.y;
      u[d + 2] = vo.z;
      V[i].a = mk(u[d + 3], u[d + 4], u[d + 5]);
      V[i].l = vo;
    } else if (one_dof(t)) {
      const V3 w = qrot(quat[i], ld3(c_m.axis[i]));
      if (t == J_HINGE) {
        S[d].a = w;
        S[d].l = vcross(posr[i], w);
      } else {
        S[d].a = zero3;
        S[d].l = w;
      }
      V[i] = sv_add(base, sv_scale(S[d], u[d]));
    } else {  // FIXED: the parent's motion
      V[i] = base;
    }
  }

  // ---------------- 6x6 spatial inertias about p0
  float I6[NB][6][6];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const Q4 qq = quat[i];
    const float w = qq.w, x = qq.x, y = qq.y, z = qq.z;
    const float R[3][3] = {
        {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z),
         2.0f * (x * z + w * y)},
        {2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z),
         2.0f * (y * z - w * x)},
        {2.0f * (x * z - w * y), 2.0f * (y * z + w * x),
         1.0f - 2.0f * (x * x + y * y)}};
    const float* cm = c_m.com[i];
    float Rc[3];
    for (int r = 0; r < 3; ++r)
      Rc[r] = R[r][0] * cm[0] + R[r][1] * cm[1] + R[r][2] * cm[2];
    const V3 cc = vadd(posr[i], mk(Rc[0], Rc[1], Rc[2]));
    float RI[3][3], Ic[3][3];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        RI[r][k] = R[r][0] * c_m.inertia[i][0][k] +
                   R[r][1] * c_m.inertia[i][1][k] +
                   R[r][2] * c_m.inertia[i][2][k];
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k)
        Ic[r][k] = RI[r][0] * R[k][0] + RI[r][1] * R[k][1] + RI[r][2] * R[k][2];
    const float mi = c_m.mass[i];
    const float cx[3][3] = {{0.0f, -cc.z, cc.y}, {cc.z, 0.0f, -cc.x},
                            {-cc.y, cc.x, 0.0f}};
    for (int r = 0; r < 3; ++r)
      for (int k = 0; k < 3; ++k) {
        const float cxcx =
            cx[r][0] * cx[0][k] + cx[r][1] * cx[1][k] + cx[r][2] * cx[2][k];
        I6[i][r][k] = Ic[r][k] - mi * cxcx;
        I6[i][r][3 + k] = mi * cx[r][k];
        I6[i][3 + r][k] = -mi * cx[r][k];
        I6[i][3 + r][3 + k] = r == k ? 0.0f + mi : 0.0f;
      }
  }

  // ---------------- contacts: probes vs plane + static boxes
  float fx[NPR], fy[NPR], fz[NPR], imp[NPR], vmin[NPR];
  V3 pr[NPR];  // probe point relative to p0 (torque arm)
#if NDB > 0
  V3 pwa[NPR], vva[NPR];  // probe point and velocity, for stage g
#endif
#pragma unroll 1
  for (int k = 0; k < NPR; ++k) {
    const int b = c_m.probe_body[k];
    const V3 rq = qrot(quat[b], ld3(c_m.probe_off[k]));
    const V3 pw = vadd(pos[b], rq);
    const V3 vv = vadd(V[b].l, vcross(V[b].a, vadd(posr[b], rq)));
    const V3 vb = vadd(V[b].l, vcross(V[b].a, posr[b]));
    pr[k] = vsub(pw, p0);
#if NDB > 0
    pwa[k] = pw;
    vva[k] = vv;
#endif
    const float rad = c_m.probe_rad[k], fric = c_m.probe_fric[k];
    const float kn = c_m.probe_kn[k], cn = c_m.probe_cn[k];

    Contact cf = contact_force(pw.z - rad, mk(0.0f, 0.0f, 1.0f), vv, vb, kn,
                               cn, fric);
    float afx = cf.fx, afy = cf.fy, afz = cf.fz, aimp = cf.fn,
          avmin = cf.vn_body;
#pragma unroll 1
    for (int j = 0; j < NSB; ++j) {
      const V3 bmin = ld3(c_m.box_min[j]);
      const V3 bmax = ld3(c_m.box_max[j]);
      const float dx = pw.x - clipp(pw.x, bmin.x, bmax.x);
      const float dy = pw.y - clipp(pw.y, bmin.y, bmax.y);
      const float dz = pw.z - clipp(pw.z, bmin.z, bmax.z);
      const float d_out = sqrtf(dx * dx + dy * dy + dz * dz);
      const bool outside = d_out > 1e-9f;
      const float inv = 1.0f / (outside ? d_out : 1.0f);
      const float fl[6] = {pw.x - bmin.x, bmax.x - pw.x, pw.y - bmin.y,
                           bmax.y - pw.y, pw.z - bmin.z, bmax.z - pw.z};
      float ni[3];
      const float d_in = nearest_face(fl, ni);
      const V3 n = outside ? mk(dx * inv, dy * inv, dz * inv)
                           : mk(ni[0], ni[1], ni[2]);
      const float dist = (outside ? d_out : -d_in) - rad;
      const Contact g = contact_force(dist, n, vv, vb, kn, cn, fric);
      afx = afx + g.fx;
      afy = afy + g.fy;
      afz = afz + g.fz;
      aimp = aimp + g.fn;
      avmin = minp(avmin, g.vn_body);
    }
    fx[k] = afx;
    fy[k] = afy;
    fz[k] = afz;
    imp[k] = aimp;
    vmin[k] = avmin;
  }

  // per-body world-contact impulse budget, probes in index order
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    float imp_b = 0.0f, vmin_b = 0.0f;
    bool any = false;
    for (int k = 0; k < NPR; ++k) {
      if (c_m.probe_body[k] != b) continue;
      if (!any) {
        imp_b = imp[k];
        vmin_b = vmin[k];
        any = true;
      } else {
        imp_b = imp_b + imp[k];
        vmin_b = minp(vmin_b, vmin[k]);
      }
    }
    if (!any) continue;
    const float fade_b = clipp(1.0f - vmin_b * c_m.inv_vreb, 0.0f, 1.0f);
    const float allow_b = c_m.support_f * fade_b +
                          c_m.mass[b] * maxp(c_m.vreb - vmin_b, 0.0f) / dt;
    const float s_b = minp(allow_b / maxp(imp_b, 1e-9f), 1.0f);
    for (int k = 0; k < NPR; ++k) {
      if (c_m.probe_body[k] != b) continue;
      fx[k] = fx[k] * s_b;
      fy[k] = fy[k] * s_b;
      fz[k] = fz[k] * s_b;
    }
  }

  // global vertical-thrust budget against the COM vertical velocity
  float vz_com = 0.0f;
  for (int b = 0; b < NB; ++b) {
    const float vb_z = vadd(V[b].l, vcross(V[b].a, posr[b])).z;
    const float term = vb_z * c_m.mass[b];
    vz_com = b == 0 ? term : vz_com + term;
  }
  vz_com = vz_com * c_m.inv_m_total;
  const float up_fade = clipp(1.0f - vz_com * c_m.inv_vreb, 0.0f, 1.0f);
  const float allow_up = c_m.support_f * up_fade +
                         c_m.m_total * maxp(c_m.vreb - vz_com, 0.0f) / dt;
  float f_up = maxp(fz[0], 0.0f);
  for (int k = 1; k < NPR; ++k) f_up = f_up + maxp(fz[k], 0.0f);
  const float s_up = minp(allow_up / maxp(f_up, 1e-9f), 1.0f);

  SV fext[NB];
  for (int b = 0; b < NB; ++b) {
    fext[b].a = zero3;
    fext[b].l = zero3;
  }
#if NDB > 0
  // ---------------- dynamic OBBs (stage g), after both budgets: probes in
  // the box frame against the box; the reaction, summed over the probes in
  // probe order, acts on the box body (pallas_ant.py:500-586)
  for (int k = 0; k < NPR; ++k) fz[k] = fz[k] > 0.0f ? fz[k] * s_up : fz[k];
#define FZ_UP(k) fz[k]
#pragma unroll 1
  for (int j = 0; j < NDB; ++j) {
    const int b2 = c_m.dbox_body[j];
    const V3 half = ld3(c_m.dbox_half[j]);
    Q4 bq = quat[b2];
    if (!c_m.dbox_ident[j]) bq = qmul(quat[b2], ldq(c_m.dbox_quat[j]));
    const V3 bp = vadd(pos[b2], qrot(quat[b2], ld3(c_m.dbox_pos[j])));
    Q4 cbq = bq;
    cbq.x = -bq.x;
    cbq.y = -bq.y;
    cbq.z = -bq.z;
    const SV Vb = V[b2];
    V3 rn = zero3, rf = zero3;  // reaction sums: torque about p0, force
#pragma unroll 1
    for (int k = 0; k < NPR; ++k) {
      const V3 l = qrot(cbq, vsub(pwa[k], bp));
      const float dx = l.x - clipp(l.x, -half.x, half.x);
      const float dy = l.y - clipp(l.y, -half.y, half.y);
      const float dz = l.z - clipp(l.z, -half.z, half.z);
      const float d_out = sqrtf(dx * dx + dy * dy + dz * dz);
      const bool outside = d_out > 1e-9f;
      const float inv = 1.0f / (outside ? d_out : 1.0f);
      const float fl[6] = {l.x + half.x, half.x - l.x, l.y + half.y,
                           half.y - l.y, l.z + half.z, half.z - l.z};
      float ni[3];
      const float d_in = nearest_face(fl, ni);
      const V3 n = qrot(bq, outside ? mk(dx * inv, dy * inv, dz * inv)
                                    : mk(ni[0], ni[1], ni[2]));
      const float dist = (outside ? d_out : -d_in) - c_m.probe_rad[k];
      // relative velocity: probe minus the box body's point velocity
      const V3 r = pr[k];
      const V3 vbp = mk(Vb.l.x + Vb.a.y * r.z - Vb.a.z * r.y,
                        Vb.l.y + Vb.a.z * r.x - Vb.a.x * r.z,
                        Vb.l.z + Vb.a.x * r.y - Vb.a.y * r.x);
      float f_n, pen;
      const V3 g0 = penalty_force(dist, n, vsub(vva[k], vbp), c_m.probe_kn[k],
                                  c_m.probe_cn[k], c_m.probe_fric[k], f_n,
                                  pen);
      const V3 g = vscale(g0, c_m.dbox_keep[j][k]);
      fx[k] = fx[k] + g.x;
      fy[k] = fy[k] + g.y;
      fz[k] = fz[k] + g.z;
      const V3 no = vcross(r, g);
      rn = k == 0 ? no : vadd(rn, no);
      rf = k == 0 ? g : vadd(rf, g);
    }
    fext[b2].a = vadd(fext[b2].a, vsub(zero3, rn));
    fext[b2].l = vadd(fext[b2].l, vsub(zero3, rf));
  }
#else
#define FZ_UP(k) (fz[k] > 0.0f ? fz[k] * s_up : fz[k])
#endif

  // probe forces to bodies as [n_o; f] about p0, in probe order
#pragma unroll 1
  for (int k = 0; k < NPR; ++k) {
    SV f;
    f.l = mk(fx[k], fy[k], FZ_UP(k));
    f.a = vcross(pr[k], f.l);
    const int b = c_m.probe_body[k];
    fext[b] = sv_add(fext[b], f);
  }
#undef FZ_UP

  // ---------------- bias forces (RNEA, qacc = 0)
  SV a0;
  a0.a = zero3;
  a0.l = mk(0.0f - c_m.gravity[0], 0.0f - c_m.gravity[1],
            0.0f - c_m.gravity[2]);
  SV A[NB];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int p = c_m.parent[i], t = c_m.jnt_type[i], d = c_m.dofadr[i];
    if (p < 0 || t == J_FREE)
      A[i] = a0;
    else if (one_dof(t))
      A[i] = sv_add(A[p], cross_motion(V[p], sv_scale(S[d], u[d])));
    else  // FIXED
      A[i] = A[p];
  }
  SV fb[NB];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const SV net = sv_add(i6vec(I6[i], A[i]),
                          cross_force(V[i], i6vec(I6[i], V[i])));
    fb[i].a = vsub(net.a, fext[i].a);
    fb[i].l = vsub(net.l, fext[i].l);
  }
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = c_m.parent[i];
    if (p < 0) continue;
    fb[p] = sv_add(fb[p], fb[i]);
  }
  float rhs[NV];
#pragma unroll 1
  for (int d = 0; d < NV; ++d) {
    const SV f = fb[dof_body(d)];
    rhs[d] = vdot(S[d].a, f.a) + vdot(S[d].l, f.l);  // tau_bias for now
  }

#if HAS_SERVO
  // ---------------- gravity compensation of the servos: the zero-velocity,
  // no-contact RNEA, i.e. subtree sums of I6 a0 (pallas_ant.py:664-678);
  // fb's storage is reused, RNEA is done
#pragma unroll 1
  for (int i = 0; i < NB; ++i) fb[i] = i6vec(I6[i], a0);
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = c_m.parent[i];
    if (p < 0) continue;
    fb[p] = sv_add(fb[p], fb[i]);
  }
  float tau_grav[NV];
#pragma unroll 1
  for (int d = 0; d < NV; ++d) {
    const SV f = fb[dof_body(d)];
    tau_grav[d] = vdot(S[d].a, f.a) + vdot(S[d].l, f.l);
  }
#endif

  // ---------------- CRBA: composite inertias in place of I6 (RNEA is done)
#pragma unroll 1
  for (int i = NB - 1; i > 0; --i) {
    const int p = c_m.parent[i];
    if (p < 0) continue;
    for (int r = 0; r < 6; ++r)
      for (int k = 0; k < 6; ++k) I6[p][r][k] = I6[p][r][k] + I6[i][r][k];
  }
  float L[NLT];  // lower triangle of M, then of its Cholesky factor
#pragma unroll 1
  for (int d = 0; d < NV; ++d) {
    const int bd = dof_body(d);
    const SV F6 = i6vec(I6[bd], S[d]);
    for (int e = 0; e <= d; ++e) {
      float val = 0.0f;
      if ((c_m.anc_mask[bd] >> dof_body(e)) & 1) {
        val = vdot(S[e].a, F6.a) + vdot(S[e].l, F6.l);
        if (d == e) val = val + c_m.armature[d];
      }
      L[lt(d, e)] = val;
    }
  }

  // ---------------- applied + passive torques; rhs = tau - tau_bias
  float tau[NV];
  for (int d = 0; d < NV; ++d) tau[d] = 0.0f - c_m.damping[d] * u[d];
  for (int a = 0; a < NU; ++a) {
    const int d = c_m.act_dof[a];
#if HAS_SERVO
    if (c_m.act_type[a] == 1) {  // PD position servo, force-limited
      const float f = c_m.act_kp[a] * (ctrl[a] - q[c_m.act_qadr[a]]) -
                      c_m.act_kd[a] * u[d] + tau_grav[d];
      tau[d] = tau[d] + clipp(f, -c_m.act_force[a], c_m.act_force[a]);
      continue;
    }
#endif
    tau[d] = tau[d] + c_m.act_gear[a] * clipp(ctrl[a], -1.0f, 1.0f);
  }
  for (int i = 0; i < NB; ++i) {
    if (!one_dof(c_m.jnt_type[i])) continue;
    const int d = c_m.dofadr[i];
    if (!c_m.lim_on[d]) continue;
    const float qi = q[c_m.qposadr[i]];
    const float over = maxp(qi - c_m.lim_hi[d], 0.0f);
    const float under = maxp(c_m.lim_lo[d] - qi, 0.0f);
    const bool active = (over > 0.0f) || (under > 0.0f);
    tau[d] = tau[d] - c_m.lim_k * (over - under) -
             (active ? c_m.lim_c * u[d] : 0.0f);
  }
  for (int d = 0; d < NV; ++d) rhs[d] = tau[d] - rhs[d];

  // ---------------- Cholesky solve (dense, fixed order)
#pragma unroll 1
  for (int j = 0; j < NV; ++j) {
    const float dj = sqrtf(maxp(L[lt(j, j)], 1e-9f));
    const float inv_dj = 1.0f / dj;
    for (int i2 = j; i2 < NV; ++i2) L[lt(i2, j)] = L[lt(i2, j)] * inv_dj;
    for (int i2 = j + 1; i2 < NV; ++i2)
      for (int k2 = j + 1; k2 <= i2; ++k2)
        L[lt(i2, k2)] = L[lt(i2, k2)] - L[lt(i2, j)] * L[lt(k2, j)];
  }
  float y[NV];
#pragma unroll 1
  for (int i2 = 0; i2 < NV; ++i2) {
    float acc = rhs[i2];
    for (int k2 = 0; k2 < i2; ++k2) acc = acc - L[lt(i2, k2)] * y[k2];
    y[i2] = acc / L[lt(i2, i2)];
  }
  float ud[NV];
#pragma unroll 1
  for (int i2 = NV - 1; i2 >= 0; --i2) {
    float acc = y[i2];
    for (int k2 = i2 + 1; k2 < NV; ++k2) acc = acc - L[lt(k2, i2)] * ud[k2];
    ud[i2] = acc / L[lt(i2, i2)];
  }

  // ---------------- integrate (semi-implicit, hard velocity clamps)
  const float vmax = c_m.vmax;
  float un[NV];
  for (int d = 0; d < NV; ++d) un[d] = clipp(u[d] + dt * ud[d], -vmax, vmax);
  float qn_[NQ];
  for (int k = 0; k < NQ; ++k) qn_[k] = q[k];
  for (int d = 0; d < NV; ++d) qd[d] = un[d];
#pragma unroll 1
  for (int i = 0; i < NB; ++i) {
    const int t = c_m.jnt_type[i], qa = c_m.qposadr[i], d = c_m.dofadr[i];
    if (t == J_FREE) {
      const V3 w_new = mk(un[d + 3], un[d + 4], un[d + 5]);
      V3 vp = vadd(mk(un[d], un[d + 1], un[d + 2]), vcross(w_new, posr[i]));
      vp = mk(clipp(vp.x, -vmax, vmax), clipp(vp.y, -vmax, vmax),
              clipp(vp.z, -vmax, vmax));
      qn_[qa] = q[qa] + dt * vp.x;
      qn_[qa + 1] = q[qa + 1] + dt * vp.y;
      qn_[qa + 2] = q[qa + 2] + dt * vp.z;
      const float angle =
          sqrtf(w_new.x * w_new.x + w_new.y * w_new.y + w_new.z * w_new.z);
      const float safe = angle > 1e-9f ? angle : 1.0f;
      const float axx = w_new.x / safe, axy = w_new.y / safe,
                  axz = w_new.z / safe;
      const float half = angle * dt * 0.5f;
      const float sh = sinf(half);
      Q4 dq;
      dq.w = cosf(half);
      dq.x = axx * sh;
      dq.y = axy * sh;
      dq.z = axz * sh;
      const Q4 qn = qmul(dq, ldq(q + qa + 3));
      const float norm =
          sqrtf(qn.w * qn.w + qn.x * qn.x + qn.y * qn.y + qn.z * qn.z);
      qn_[qa + 3] = qn.w / norm;
      qn_[qa + 4] = qn.x / norm;
      qn_[qa + 5] = qn.y / norm;
      qn_[qa + 6] = qn.z / norm;
      qd[d] = vp.x;
      qd[d + 1] = vp.y;
      qd[d + 2] = vp.z;
    } else if (one_dof(t)) {
      float qv = q[qa] + dt * un[d];
      float qdv = un[d];
      if (c_m.lim_on[d]) {  // inelastic limit stops
        const float lo = c_m.lim_lo[d], hi = c_m.lim_hi[d];
        qdv = qv < lo ? maxp(qdv, 0.0f) : qdv;
        qdv = qv > hi ? minp(qdv, 0.0f) : qdv;
        qv = clipp(qv, lo, hi);
      }
      qn_[qa] = qv;
      qd[d] = qdv;
    }
  }
  for (int k = 0; k < NQ; ++k) q[k] = qn_[k];
}

__global__ void substep_kernel(const float* __restrict__ qpos,
                               const float* __restrict__ qvel,
                               const float* __restrict__ ctrl,
                               float* __restrict__ qpos_out,
                               float* __restrict__ qvel_out, int B) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= B) return;
  float q[NQ], qd[NV], ct[NU];
  for (int k = 0; k < NQ; ++k) q[k] = qpos[(size_t)env * NQ + k];
  for (int k = 0; k < NV; ++k) qd[k] = qvel[(size_t)env * NV + k];
  for (int k = 0; k < NU; ++k) ct[k] = ctrl[(size_t)env * NU + k];
#pragma unroll 1
  for (int s = 0; s < NSUB; ++s) substep(q, qd, ct);
  for (int k = 0; k < NQ; ++k) qpos_out[(size_t)env * NQ + k] = q[k];
  for (int k = 0; k < NV; ++k) qvel_out[(size_t)env * NV + k] = qd[k];
}

// ---------------------------------------------------------------------------
// plain C interface, bound with ctypes in physics/substep_cuda.py

extern "C" int substep_model_bytes() { return (int)sizeof(SubstepModel); }

extern "C" int substep_set_model(const void* host_model) {
  return (int)cudaMemcpyToSymbol(c_m, host_model, sizeof(SubstepModel));
}

// 32 threads a block: at the main path's 4096 envs that is 128 blocks, one
// warp on nearly every one of the H100's 132 SMs.
extern "C" int substep_launch(const float* qpos, const float* qvel,
                              const float* ctrl, float* qpos_out,
                              float* qvel_out, int B, void* stream) {
  if (B <= 0) return 0;
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  substep_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      qpos, qvel, ctrl, qpos_out, qvel_out, B);
  return (int)cudaGetLastError();
}

extern "C" const char* substep_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
