"""Trusted CPU oracle: a slow, scalar-per-ray, f64 numpy renderer.

The port's own copy of ``raytracinginoneweekendincuda_tpu/testing/oracle.py``
(numpy only: no torch, and nothing of the port's batched engines).  It
mirrors the *book's* recursive structure (one ray at a time, primitives
checked with a shrinking closest-t exactly like HittableList.h:39-57 /
kernel.cu:65-98) and shares only two contracts with the batched engines --
the counter-RNG draw slots (`core/rng.py`, its numpy path) and the
analytic samplers (`core/samplers.py`, its numpy path) -- so an
engine-vs-oracle match validates the engines' vectorized reformulation
(coefficient-form quadratics, argmin closest hit, BVH traversal, masked
shading) rather than comparing a function to itself.  Its frames are the
JAX package's oracle's, bit for bit.

Everything is float64; an engine run in f64 must agree to ~1e-12 except
on measure-zero discrete boundaries (root-validity / Schlick-lottery
flips), which `testing/compare.py` absorbs.
"""

from __future__ import annotations

import numpy as np

from ..core import rng, samplers
from ..scene.compiler import (
    MAT_DIELECTRIC,
    MAT_DIFFUSE_LIGHT,
    MAT_ISOTROPIC,
    MAT_LAMBERTIAN,
    MAT_METAL,
    MED_BOX,
    SceneArrays,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_NOISE,
    TEX_SOLID,
)

_U32 = lambda x: np.asarray(x, np.uint32)


def _uniform4(pix_ctr, samp, stream, slot):
    with np.errstate(over="ignore"):
        return rng.uniform4_numpy(
            _U32(pix_ctr), _U32(samp), _U32(stream), _U32(slot),
            float_dtype=np.float64)


def _uniform_open(pix_ctr, samp, stream, slot):
    with np.errstate(over="ignore"):
        return rng.uniform_open4_numpy(
            _U32(pix_ctr), _U32(samp), _U32(stream), _U32(slot),
            float_dtype=np.float64)[0]


class Oracle:
    def __init__(self, scene: SceneArrays, meta, width: int, height: int, seed: int):
        assert scene.sph_c0.dtype == np.float64, "compile the oracle scene in f64"
        self.s = scene
        self.meta = meta
        self.W = width
        self.H = height
        self.seed = seed

    # ------------------------------------------------------------- camera

    def _get_ray(self, pix_ctr, i, j, samp):
        cam = self.s.camera
        ju, jv, l1, l2 = _uniform4(pix_ctr, samp, rng.CAMERA_STREAM, 0)
        tu = _uniform4(pix_ctr, samp, rng.CAMERA_STREAM + 1, 0)[0]
        su = (i + ju) / self.W
        tv = (j + jv) / self.H
        rd = float(cam.lens_radius) * samplers.unit_disk_numpy(l1, l2)
        offset = cam.u * rd[..., 0] + cam.v * rd[..., 1]
        origin = cam.origin + offset
        direction = (
            cam.lower_left + su * cam.horizontal + tv * cam.vertical - cam.origin - offset
        )
        time = float(cam.time0) + tu * (float(cam.time1) - float(cam.time0))
        return origin, direction, float(time)

    # ---------------------------------------------------------------- hit

    def _hit_spheres(self, o, d, time, t_min, closest):
        """Reference Sphere/MovingSphere::Hit over the sphere table, with the
        list walk's shrinking closest (HittableList.h:39-57).  Vectorized over
        the table with the *direct* oc-form coefficients (not the engine's
        matmul expansion) so engine-vs-oracle still compares two formulations;
        nearest-valid-root + argmin is provably the same selection as the
        shrinking-tMax walk."""
        s = self.s
        n = self.meta.n_spheres
        if n == 0:
            return None, closest
        frac = (time - s.sph_t0[:n]) * s.sph_inv_dt[:n]
        center = s.sph_c0[:n] + frac[:, None] * s.sph_dc[:n]
        oc = o[None, :] - center
        a = float(d @ d)
        b = oc @ d
        c = (oc * oc).sum(-1) - s.sph_rad[:n] ** 2
        disc = b * b - a * c
        with np.errstate(invalid="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
        root1 = (-b - sq) / a
        root2 = (-b + sq) / a
        t_cand = np.where(root1 > t_min, root1, root2)
        ok = (disc > 0.0) & (t_cand > t_min) & (t_cand < closest)
        if not ok.any():
            return None, closest
        t_cand = np.where(ok, t_cand, np.inf)
        idx = int(t_cand.argmin())
        t = float(t_cand[idx])
        closest = t
        p = o + t * d
        n_out = (p - center[idx]) / s.sph_rad[idx]
        cth, sth = s.sph_cos[idx], s.sph_sin[idx]
        ox = cth * n_out[0] - sth * n_out[2]
        oz = sth * n_out[0] + cth * n_out[2]
        theta = np.arccos(np.clip(-n_out[1], -1.0, 1.0))
        phi = np.arctan2(-oz, ox) + np.pi
        rec = dict(
            t=t, p=p, n_out=n_out, u=phi / (2 * np.pi), v=theta / np.pi,
            mat=int(s.sph_mat[idx]),
        )
        return rec, closest

    def _hit_quads(self, o, d, t_min, closest):
        """Quad::Hit (Quad.h:52-99) vectorized over the table: direct plane
        intersection + w.(pvec x v) interior coordinates."""
        s = self.s
        nq = self.meta.n_quads
        if nq == 0:
            return None, closest
        q, u, v = s.quad_q[:nq], s.quad_u[:nq], s.quad_v[:nq]
        n = np.cross(u, v)
        n_unit = n / np.linalg.norm(n, axis=-1, keepdims=True)
        denom = n_unit @ d
        denom_ok = np.abs(denom) >= 1e-8
        denom_safe = np.where(denom_ok, denom, 1.0)
        t = ((n_unit * q).sum(-1) - n_unit @ o) / denom_safe
        w = n / (n * n).sum(-1, keepdims=True)
        pvec = o[None, :] + t[:, None] * d[None, :] - q
        alpha = (w * np.cross(pvec, v)).sum(-1)
        beta = (w * np.cross(u, pvec)).sum(-1)
        ok = (
            denom_ok
            & (t >= t_min) & (t <= closest)
            & (alpha >= 0.0) & (alpha <= 1.0)
            & (beta >= 0.0) & (beta <= 1.0)
        )
        if not ok.any():
            return None, closest
        t_cand = np.where(ok, t, np.inf)
        idx = int(t_cand.argmin())
        closest = float(t_cand[idx])
        rec = dict(
            t=closest, p=o + closest * d, n_out=n_unit[idx],
            u=float(alpha[idx]), v=float(beta[idx]), mat=int(s.quad_mat[idx]),
        )
        return rec, closest

    def _hit_media(self, o, d, t_min, closest, pix_ctr, samp, bounce):
        """ConstantMedium::Hit (h:52-94) with the shrinking-tMax list walk."""
        s = self.s
        rec = None
        for m in range(self.meta.n_media):
            u_draw = float(_uniform_open(pix_ctr, samp, rng.MEDIUM_STREAM | bounce, m))
            if s.med_kind[m] == MED_BOX:
                c, sn = s.med_cos[m], s.med_sin[m]
                po = o - s.med_off[m]
                o_obj = np.array([c * po[0] - sn * po[2], po[1], sn * po[0] + c * po[2]])
                d_obj = np.array([c * d[0] - sn * d[2], d[1], sn * d[0] + c * d[2]])
                with np.errstate(divide="ignore", invalid="ignore"):
                    ta = (s.med_bmin[m] - o_obj) / d_obj
                    tb = (s.med_bmax[m] - o_obj) / d_obj
                t0 = np.minimum(ta, tb).max()
                t1 = np.maximum(ta, tb).min()
                if not (t1 > t0):
                    continue
            else:
                oc = o - s.med_center[m]
                a = float(d @ d)
                b = float(oc @ d)
                cq = float(oc @ oc) - s.med_radius[m] ** 2
                disc = b * b - a * cq
                if disc <= 0.0:
                    continue
                sq = np.sqrt(disc)
                t0 = (-b - sq) / a
                t1 = (-b + sq) / a
            if not (t1 > t0 + 1e-4):
                continue
            e = max(t0, t_min)
            x = min(t1, closest)     # clip exit by current closest (tMax)
            if e >= x:
                continue
            if e < 0.0:
                e = 0.0
            ray_len = float(np.linalg.norm(d))
            dist_inside = (x - e) * ray_len
            hit_dist = s.med_nid[m] * np.log(u_draw)
            if hit_dist > dist_inside:
                continue
            t = e + hit_dist / ray_len
            rec = dict(
                t=t, p=o + t * d, n_out=np.array([1.0, 0.0, 0.0]), u=0.0, v=0.0,
                mat=int(s.med_mat[m]), is_medium=True,
            )
            closest = t
        return rec, closest

    def _hit_world(self, o, d, time, t_min, pix_ctr, samp, bounce):
        closest = np.inf
        rec, closest = self._hit_spheres(o, d, time, t_min, closest)
        rq, closest = self._hit_quads(o, d, t_min, closest)
        if rq is not None:
            rec = rq
        rm, closest = self._hit_media(o, d, t_min, closest, pix_ctr, samp, bounce)
        if rm is not None:
            rec = rm
        if rec is None:
            return None
        if rec.get("is_medium"):
            rec["front"] = True       # arbitrary (ConstantMedium.h:89-90)
            rec["normal"] = rec["n_out"]
        else:
            rec["front"] = bool(d @ rec["n_out"] < 0.0)
            rec["normal"] = rec["n_out"] if rec["front"] else -rec["n_out"]
        return rec

    # ------------------------------------------------------------ shading

    def _texture_value(self, tex_id, u, v, p):
        s = self.s
        kind = int(s.tex_kind[tex_id])
        if kind == TEX_SOLID:
            return s.tex_c0[tex_id].copy()
        if kind == TEX_CHECKER:
            cell = np.floor(s.tex_inv_scale[tex_id] * p).astype(np.int64)
            return s.tex_c0[tex_id] if (cell.sum() % 2) == 0 else s.tex_c1[tex_id]
        if kind == TEX_IMAGE:
            iid = int(s.tex_image[tex_id])
            if iid < 0:
                return np.array([0.0, 1.0, 1.0])
            w, h = int(s.img_w[iid]), int(s.img_h[iid])
            uu = np.clip(u, 0.0, 1.0)
            vv = 1.0 - np.clip(v, 0.0, 1.0)
            i = min(int(uu * w), w - 1)
            j = min(int(vv * h), h - 1)
            return s.img_data[iid, j, i].copy()
        if kind == TEX_NOISE:
            nid = int(s.tex_noise[tex_id])
            turb = self._turb(nid, p, 7)
            return np.full(3, 0.5) * (1.0 + np.sin(s.tex_scale[tex_id] * p[2] + 10.0 * turb))
        raise AssertionError(kind)

    def _noise(self, nid, p):
        s = self.s
        fl = np.floor(p)
        u, v, w = p - fl
        i, j, k = fl.astype(np.int64)
        uu = u * u * (3 - 2 * u)
        vv = v * v * (3 - 2 * v)
        ww = w * w * (3 - 2 * w)
        accum = 0.0
        for di in range(2):
            for dj in range(2):
                for dk in range(2):
                    idx = (
                        s.perlin_px[nid, (i + di) & 255]
                        ^ s.perlin_py[nid, (j + dj) & 255]
                        ^ s.perlin_pz[nid, (k + dk) & 255]
                    )
                    grad = s.perlin_vec[nid, idx]
                    weight = np.array([u - di, v - dj, w - dk])
                    accum += (
                        (di * uu + (1 - di) * (1 - uu))
                        * (dj * vv + (1 - dj) * (1 - vv))
                        * (dk * ww + (1 - dk) * (1 - ww))
                        * float(grad @ weight)
                    )
        return accum

    def _turb(self, nid, p, depth):
        accum, weight, q = 0.0, 1.0, p.copy()
        for _ in range(depth):
            accum += weight * self._noise(nid, q)
            weight *= 0.5
            q = q * 2.0
        return abs(accum)

    def _scatter(self, rec, d_in, pix_ctr, samp, bounce):
        """Returns (emitted, ok, attenuation, new_dir)."""
        s = self.s
        mk = int(s.mat_kind[rec["mat"]])
        tex = int(s.mat_tex[rec["mat"]])
        u1, u2, u3, u4 = (
            float(x) for x in _uniform4(pix_ctr, samp, rng.SCATTER_STREAM | bounce, 0)
        )
        texv = self._texture_value(tex, rec["u"], rec["v"], rec["p"]) if tex >= 0 else None

        emitted = np.zeros(3)
        if mk == MAT_DIFFUSE_LIGHT:
            emitted = texv
            return emitted, False, None, None

        ball = samplers.unit_ball_numpy(np.float64(u1), np.float64(u2),
                                        np.float64(u3))
        normal = rec["normal"]
        if mk == MAT_LAMBERTIAN:
            nd = normal + ball
            if np.all(np.abs(nd) < 1e-8):
                nd = normal
            return emitted, True, texv, nd
        if mk == MAT_METAL:
            unit_d = d_in / np.linalg.norm(d_in)
            refl = unit_d - 2.0 * float(unit_d @ normal) * normal
            nd = refl + s.mat_fuzz[rec["mat"]] * ball
            ok = float(nd @ normal) > 0.0
            return emitted, ok, texv, nd
        if mk == MAT_DIELECTRIC:
            ior = float(s.mat_ior[rec["mat"]])
            ratio = (1.0 / ior) if rec["front"] else ior
            unit_d = d_in / np.linalg.norm(d_in)
            cos_t = min(float(-unit_d @ normal), 1.0)
            sin_t = np.sqrt(max(1.0 - cos_t * cos_t, 0.0))
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            reflect_prob = r0 + (1 - r0) * (1 - cos_t) ** 5
            if ratio * sin_t > 1.0 or reflect_prob > u4:
                nd = unit_d - 2.0 * float(unit_d @ normal) * normal
            else:
                r_perp = ratio * (unit_d + cos_t * normal)
                r_par = -np.sqrt(abs(1.0 - float(r_perp @ r_perp))) * normal
                nd = r_perp + r_par
            return emitted, True, np.ones(3), nd
        if mk == MAT_ISOTROPIC:
            nd = samplers.unit_sphere_surface_numpy(np.float64(u1),
                                                    np.float64(u2))
            return emitted, True, texv, nd
        raise AssertionError(mk)

    # --------------------------------------------------------- integrator

    def ray_color(self, o, d, time, pix_ctr, samp, max_bounces=50, t_min=1e-3):
        """Iterative RayColor (kernel.cu:65-98)."""
        background = np.asarray(self.s.camera.background, np.float64)
        thr = np.ones(3)
        acc = np.zeros(3)
        for bounce in range(max_bounces):
            rec = self._hit_world(o, d, time, t_min, pix_ctr, samp, bounce)
            if rec is None:
                return acc + thr * background
            emitted, ok, atten, nd = self._scatter(rec, d, pix_ctr, samp, bounce)
            acc = acc + thr * emitted
            if not ok:
                return acc
            thr = thr * atten
            o, d = rec["p"], nd
        return acc

    def render(self, spp: int, max_bounces: int = 50, t_min: float = 1e-3):
        """Full frame [H,W,3] (top row first), gamma-2 corrected."""
        img = np.zeros((self.H, self.W, 3))
        for j in range(self.H):
            for i in range(self.W):
                pix = j * self.W + i
                pix_ctr = np.uint32(pix) ^ np.uint32(self.seed)
                col = np.zeros(3)
                for sidx in range(spp):
                    o, d, time = self._get_ray(pix_ctr, i, j, sidx)
                    col += self.ray_color(
                        o, d, time, pix_ctr, sidx, max_bounces=max_bounces,
                        t_min=t_min)
                img[self.H - 1 - j, i] = np.sqrt(np.maximum(col / spp, 0.0))
        return img
