"""Progressive renderer: camera sampling, per-sample accumulation, AOVs.

Mirrors the reference driver contract (make_trace_state src/trace.jl:189-213,
trace_samples :215-274, trace_sample :584-649, get_image :676-690) with an
accelerator execution model: one jit-compiled function renders one sample for a
whole pixel chunk, accumulating in-place into device buffers via donated
args. The per-(pixel, sample) counter-based RNG makes renders
deterministic and chunk/shard-invariant — unlike the reference's shared
global rand() (src/sampling.jl:18).

Checkpoint/resume: the accumulation state (image/albedo/normal/hits +
sample cursor) is exactly resumable — see TraceState.save/load, which
makes the progressive lerp accumulation (src/trace.jl:631-648) durable.
"""

from __future__ import annotations

import os
import math
from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from julia_raytracer.ops.camera import CameraArrays, sample_camera
from julia_raytracer.render.integrator import (
    TraceOptions, intersector_name, trace_wavefront,
)
from julia_raytracer.render.scene_device import build_device_scene
from julia_raytracer.scene.loader import find_camera
from julia_raytracer.utils import rng as rng_mod
from julia_raytracer.utils.color import luminance

MAX_CHUNK = 1 << 20  # rays per device dispatch


@dataclass
class Params:
    """All 17 reference CLI flags (src/cli.jl:13-86) + this renderer's extras."""

    scene: str = "scene.json"
    output: str = "out.png"
    camera: str = ""
    addsky: bool = False  # REAL here (scene/augment.py Preetham sun-sky); the reference stubs it (src/jtrace.jl:35-46)
    envname: str = ""  # REAL here (scene/augment.py env-from-image); stubbed in the reference
    resolution: int = 1280
    samples: int = 512
    bounces: int = 8
    denoise: bool = False  # REAL here (render/denoise.py à-trous); stubbed in the reference
    noparallel: bool = False
    highqualitybvh: bool = False
    envhidden: bool = False
    tentfilter: bool = False
    sampler: str = "path"
    clamp: float = 10.0
    nocaustics: bool = False
    batch: int = 1
    bvhstacksize: int = 128  # traversal uses fixed short stacks; kept for CLI parity
    # additions beyond the reference
    seed: int = 0
    # -1 = auto per scene (render/lights.py auto_light_pdf_steps,
    # justified by tests/test_light_pdf_fidelity.py)
    light_pdf_extra_steps: int = -1
    # adaptive sampling (beyond reference): after `adaptive_warmup`
    # uniform samples, each batch draws its pixel lanes from a
    # luminance-variance distribution (static shapes: the LANE count
    # never changes, only which pixels occupy lanes); per-pixel counts
    # make the accumulation an exact per-pixel mean, so the estimator
    # stays unbiased — allocation, not weighting
    adaptive: bool = False
    adaptive_warmup: int = 4


@dataclass
class TraceState:
    """Accumulation buffers (src/trace.jl:87-100), flat pixel-major."""

    width: int
    height: int
    samples: int
    image: jnp.ndarray  # f32 [P, 4]
    albedo: jnp.ndarray  # f32 [P, 3]
    normal: jnp.ndarray  # f32 [P, 3]
    hits: jnp.ndarray  # i32 [P]
    denoised: jnp.ndarray | None = None
    # adaptive-mode extras (None when uniform): per-pixel sample counts
    # and luminance M2 (Welford) driving the allocation distribution
    counts: jnp.ndarray | None = None  # i32 [P]
    m2: jnp.ndarray | None = None  # f32 [P]

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def save(self, path: str) -> None:
        np.savez(
            path,
            width=self.width,
            height=self.height,
            samples=self.samples,
            image=np.asarray(self.image),
            albedo=np.asarray(self.albedo),
            normal=np.asarray(self.normal),
            hits=np.asarray(self.hits),
            **(
                {"counts": np.asarray(self.counts), "m2": np.asarray(self.m2)}
                if self.counts is not None
                else {}
            ),
        )

    @staticmethod
    def load(path: str) -> "TraceState":
        z = np.load(path)
        return TraceState(
            width=int(z["width"]),
            height=int(z["height"]),
            samples=int(z["samples"]),
            image=jnp.asarray(z["image"]),
            albedo=jnp.asarray(z["albedo"]),
            normal=jnp.asarray(z["normal"]),
            hits=jnp.asarray(z["hits"]),
            counts=jnp.asarray(z["counts"]) if "counts" in z else None,
            m2=jnp.asarray(z["m2"]) if "m2" in z else None,
        )


def image_size_for(camera, resolution: int) -> tuple[int, int]:
    """Resolution lands on the long axis per camera aspect (src/trace.jl:191-197)."""
    if camera.aspect >= 1.0:
        return resolution, int(round(resolution / camera.aspect))
    return int(round(resolution * camera.aspect)), resolution


def make_trace_state(scene_data, params: Params) -> TraceState:
    cam_id = max(find_camera(scene_data, params.camera), 0)
    camera = scene_data.cameras[cam_id]
    width, height = image_size_for(camera, params.resolution)
    p = width * height
    return TraceState(
        width=width,
        height=height,
        samples=0,
        image=jnp.zeros((p, 4), jnp.float32),
        albedo=jnp.zeros((p, 3), jnp.float32),
        normal=jnp.zeros((p, 3), jnp.float32),
        hits=jnp.zeros(p, jnp.int32),
        counts=jnp.zeros(p, jnp.int32) if params.adaptive else None,
        m2=jnp.zeros(p, jnp.float32) if params.adaptive else None,
    )


def camera_arrays(camera) -> CameraArrays:
    return CameraArrays(
        frame=jnp.asarray(camera.frame),
        lens=jnp.float32(camera.lens),
        film=jnp.float32(camera.film),
        aspect=jnp.float32(camera.aspect),
        focus=jnp.float32(camera.focus),
        aperture=jnp.float32(camera.aperture),
        orthographic=bool(camera.orthographic),
    )


def _scrub_compose(radiance, hit, albedo_s, normal_s, rd, chunk,
                   clamp, envhidden, has_envs):
    """Shared per-sample post-processing for BOTH accumulation kernels:
    NaN scrub + radiance rescale clamp (src/trace.jl:625-630) and the
    image/albedo/normal contribution composition incl. the miss-vs-env
    bookkeeping. One definition so uniform and adaptive modes can never
    drift apart."""
    finite = jnp.all(jnp.isfinite(radiance), axis=-1)
    radiance = jnp.where(finite[..., None], radiance, 0.0)
    peak = jnp.max(radiance, axis=-1)
    scale = jnp.where(
        peak > clamp, clamp / jnp.maximum(peak, 1e-30), 1.0
    )
    radiance = radiance * scale[..., None]
    env_case = (~hit) & (not envhidden) & has_envs
    img_new = jnp.where(
        (hit | env_case)[..., None],
        jnp.concatenate(
            [radiance, jnp.ones((chunk, 1), jnp.float32)], axis=-1
        ),
        0.0,
    )
    alb_new = jnp.where(
        hit[..., None], albedo_s, jnp.where(env_case[..., None], 1.0, 0.0)
    )
    nrm_new = jnp.where(hit[..., None], normal_s, -rd)
    return img_new, alb_new, nrm_new, env_case


class Renderer:
    """Owns the device scene + the compiled per-sample kernel."""

    def __init__(self, scene_data, params: Params):
        from julia_raytracer.utils.diskcache import scene_cache_key

        self.params = params
        self.scene_data = scene_data
        # --addsky/--envname mutate scene_data after load (scene/augment.py
        # adds environments/textures), so they must be part of the content
        # key or a heavy-scene run with a different augmentation flag would
        # reuse stale cached light tables (wrong env CDFs -> biased MIS).
        aug = f"sky{int(params.addsky)}:env{params.envname or '-'}"
        cache_key = scene_cache_key(
            params.scene, "sah" if params.highqualitybvh else "mid", aug
        )
        self.dscene, self.config = build_device_scene(
            scene_data, highquality_bvh=params.highqualitybvh, cache_key=cache_key
        )
        cam_id = max(find_camera(scene_data, params.camera), 0)
        self.camera = scene_data.cameras[cam_id]
        self.cam_arrays = camera_arrays(self.camera)
        if params.light_pdf_extra_steps >= 0:
            pdf_steps = params.light_pdf_extra_steps
        else:
            from julia_raytracer.render.lights import auto_light_pdf_steps

            # only consulted by the fallback truncated march (scenes with
            # > EXACT_ELEMS emissive elements); every generated scene takes
            # the exact element sweep which ignores this budget.
            # transparent(3)/refractive(4)/subsurface(5)/volumetric(6)
            # put non-emissive surfaces along light paths, so emissive
            # march hits can hide deeper than the opaque-scene budget
            transmissive = bool(
                set(self.config.present_types) & {3, 4, 5, 6}
            )
            pdf_steps = auto_light_pdf_steps(
                self.config.light_counts.total, transmissive
            )
        self.options = TraceOptions(
            sampler=params.sampler,
            bounces=params.bounces,
            envhidden=params.envhidden,
            nocaustics=params.nocaustics,
            light_pdf_extra_steps=pdf_steps,
            # wavefront sorting makes BVH walks coherent in heavy
            # scenes; tiny scenes take the dense test, where coherence
            # doesn't matter. JRT_SORT=1/0 overrides.
            sort_rays=(
                os.environ["JRT_SORT"] == "1"
                if os.environ.get("JRT_SORT") in ("0", "1")
                else self.config.n_prims >= 50_000
            ),
        )
        # the intersector is built inside each jitted kernel from the
        # traced dscene, so scene arrays enter as arguments, not constants
        self.intersector = intersector_name(self.config)
        self._kernel_cache = {}

    # -- per-sample kernel ------------------------------------------------

    def _sample_kernel(self, width: int, height: int, chunk: int,
                       k: int = 1, loop_s: int = 1):
        """Compiled fn: (dscene, cam, buffers..., pixel0, sample) -> buffers.

        k > 1 traces k CONSECUTIVE samples of the same `chunk` pixels in
        one dispatch (lanes = k*chunk; sample id varies along the lane
        axis) and folds their mean into the running mean with weight
        k/(s+k) — the same mean as k sequential lerps in exact
        arithmetic. Amortizes per-dispatch host overhead for scenes
        whose pixel count is far below MAX_CHUNK.

        loop_s > 1 advances loop_s CONSECUTIVE samples inside ONE
        dispatch via lax.fori_loop — lanes stay at chunk, each
        iteration is the verbatim single-sample computation, so the
        accumulation is BIT-IDENTICAL to loop_s sequential dispatches
        (unlike k, which reassociates the mean): fewer dispatches per
        sample for small frames. Mutually exclusive with k > 1."""
        key = (width, height, chunk, k, loop_s)
        if key in self._kernel_cache:
            return self._kernel_cache[key]
        if k > 1 and loop_s > 1:
            raise ValueError("k-lane and loop_s sample batching are "
                             "mutually exclusive")

        config, options, params = self.config, self.options, self.params
        n_pixels = width * height
        has_envs = config.n_envs > 0
        orthographic = self.cam_arrays.orthographic

        def kernel(dscene, cam, image, albedo, normal, hits, pixel0,
                   sample_id0):
            def one_sample(sample_id, bufs):
                image, albedo, normal, hits = bufs
                return _body(dscene, cam, image, albedo, normal, hits,
                             pixel0, sample_id)

            if loop_s == 1:
                return one_sample(sample_id0, (image, albedo, normal, hits))
            return jax.lax.fori_loop(
                0, loop_s,
                lambda j, bufs: one_sample(sample_id0 + j, bufs),
                (image, albedo, normal, hits),
            )

        def _body(dscene, cam, image, albedo, normal, hits, pixel0, sample_id):
            cam = cam._replace(orthographic=orthographic)
            lane = jnp.arange(chunk * k, dtype=jnp.int32)
            pix_off = lane % chunk
            s_off = lane // chunk
            pixel = pixel0 + pix_off
            valid = pixel < n_pixels
            pix = jnp.clip(pixel, 0, n_pixels - 1)
            rng = rng_mod.seed_state(pix, sample_id + s_off, params.seed)
            puv, rng = rng_mod.rand2f(rng)
            luv, rng = rng_mod.rand2f(rng)
            ij = jnp.stack([pix % width, pix // width], axis=-1)
            ro, rd = sample_camera(
                cam, ij, (width, height), puv, luv, params.tentfilter
            )
            radiance, hit, albedo_s, normal_s, rng = trace_wavefront(
                dscene, config, options, ro, rd, rng,
            )

            img_new, alb_new, nrm_new, env_case = _scrub_compose(
                radiance, hit, albedo_s, normal_s, rd, chunk * k,
                params.clamp, options.envhidden, has_envs,
            )
            if k > 1:
                # mean of the k sub-samples per pixel
                img_new = img_new.reshape(k, chunk, 4).mean(axis=0)
                alb_new = alb_new.reshape(k, chunk, 3).mean(axis=0)
                nrm_new = nrm_new.reshape(k, chunk, 3).mean(axis=0)
            # running-mean accumulation (src/trace.jl:631-648)
            w = jnp.float32(k) / (sample_id.astype(jnp.float32) + k)
            w = jnp.where(valid[:chunk], w, 0.0)
            hit_lane = jnp.where(valid & (hit | env_case), 1, 0)
            hit_inc = (
                hit_lane.reshape(k, chunk).sum(axis=0) if k > 1 else hit_lane
            )

            old_img = jax.lax.dynamic_slice(image, (pixel0, 0), (chunk, 4))
            old_alb = jax.lax.dynamic_slice(albedo, (pixel0, 0), (chunk, 3))
            old_nrm = jax.lax.dynamic_slice(normal, (pixel0, 0), (chunk, 3))
            old_hit = jax.lax.dynamic_slice(hits, (pixel0,), (chunk,))
            image = jax.lax.dynamic_update_slice(
                image, old_img + (img_new - old_img) * w[..., None], (pixel0, 0)
            )
            albedo = jax.lax.dynamic_update_slice(
                albedo, old_alb + (alb_new - old_alb) * w[..., None], (pixel0, 0)
            )
            normal = jax.lax.dynamic_update_slice(
                normal, old_nrm + (nrm_new - old_nrm) * w[..., None], (pixel0, 0)
            )
            hits = jax.lax.dynamic_update_slice(hits, old_hit + hit_inc, (pixel0,))
            return image, albedo, normal, hits

        fn = jax.jit(kernel, donate_argnums=(2, 3, 4, 5))
        self._kernel_cache[key] = fn
        return fn

    def _adaptive_kernel(self, width: int, height: int, chunk: int,
                         uniform: bool):
        """Compiled fn for ADAPTIVE sampling (beyond reference).

        uniform=True: warmup — lanes cover pixel0..pixel0+chunk like the
        standard kernel, but per-pixel counts and luminance M2 (Welford)
        are accumulated too. uniform=False: the chunk's pixel ids are
        DRAWN from the sqrt-variance distribution (inverse-CDF on
        counter-based uniforms) — the lane count is static, only which
        pixels occupy lanes changes. Each drawn lane continues its
        pixel's sample sequence (sample id = count + occurrence rank),
        and the scatter-merge keeps every pixel's value an exact mean of
        its own i.i.d. samples — allocation, not weighting, so the
        estimator stays unbiased."""
        key = ("adapt", width, height, chunk, uniform)
        if key in self._kernel_cache:
            return self._kernel_cache[key]

        config, options, params = self.config, self.options, self.params
        n_pixels = width * height
        has_envs = config.n_envs > 0
        orthographic = self.cam_arrays.orthographic

        def kernel(dscene, cam, image, albedo, normal, hits, counts, m2,
                   pixel0, batch_id, n_live):
            cam = cam._replace(orthographic=orthographic)
            lane = jnp.arange(chunk, dtype=jnp.int32)
            if uniform:
                pixel = pixel0 + lane
                valid = pixel < n_pixels
                ids = jnp.clip(pixel, 0, n_pixels - 1)
                rank = jnp.zeros(chunk, jnp.int32)
            else:
                var = m2 / jnp.maximum(counts.astype(jnp.float32) - 1.0, 1.0)
                wts = jnp.sqrt(jnp.maximum(var, 0.0))
                # probability floor: every pixel keeps being sampled, so
                # per-pixel means stay consistent estimators everywhere
                wts = wts + 0.05 * jnp.mean(wts) + 1e-12
                cdf = jnp.cumsum(wts)
                cdf = cdf / cdf[-1]
                rdraw = rng_mod.seed_state(
                    lane, batch_id, params.seed + 0x5EED
                )
                u, _ = rng_mod.rand2f(rdraw)
                u = u[:, 0] if u.ndim == 2 else u
                ids = jnp.clip(
                    jnp.searchsorted(cdf, u).astype(jnp.int32),
                    0, n_pixels - 1,
                )
                # tail chunk draws fewer lanes so each adaptive round
                # adds EXACTLY n_pixels samples (budget conservation)
                valid = lane < n_live
                # occurrence rank inside this batch: duplicates of a
                # pixel must get DISTINCT sample ids or their paths (and
                # variance reduction) would be identical
                order = jnp.argsort(ids)
                sid = ids[order]
                pos = jnp.arange(chunk, dtype=jnp.int32)
                is_start = jnp.concatenate(
                    [jnp.ones(1, bool), sid[1:] != sid[:-1]]
                )
                start_pos = jax.lax.cummax(jnp.where(is_start, pos, 0))
                rank = jnp.zeros(chunk, jnp.int32).at[order].set(
                    pos - start_pos
                )
            sample_ids = counts[ids] + rank

            rng = rng_mod.seed_state(ids, sample_ids, params.seed)
            puv, rng = rng_mod.rand2f(rng)
            luv, rng = rng_mod.rand2f(rng)
            ij = jnp.stack([ids % width, ids // width], axis=-1)
            ro, rd = sample_camera(
                cam, ij, (width, height), puv, luv, params.tentfilter
            )
            radiance, hit, albedo_s, normal_s, rng = trace_wavefront(
                dscene, config, options, ro, rd, rng,
            )
            img_new, alb_new, nrm_new, env_case = _scrub_compose(
                radiance, hit, albedo_s, normal_s, rd, chunk,
                params.clamp, options.envhidden, has_envs,
            )
            vf = valid.astype(jnp.float32)
            img_new = img_new * vf[..., None]
            alb_new = alb_new * vf[..., None]
            nrm_new = nrm_new * vf[..., None]
            lum = luminance(img_new[:, :3]) * vf

            # per-pixel batch aggregates via scatter-add, then a
            # vectorized Welford/Chan merge — exact per-pixel means
            # regardless of how many lanes a pixel received
            k = jnp.zeros(n_pixels, jnp.float32).at[ids].add(vf)
            s_img = jnp.zeros((n_pixels, 4), jnp.float32).at[ids].add(img_new)
            s_alb = jnp.zeros((n_pixels, 3), jnp.float32).at[ids].add(alb_new)
            s_nrm = jnp.zeros((n_pixels, 3), jnp.float32).at[ids].add(nrm_new)
            s_l = jnp.zeros(n_pixels, jnp.float32).at[ids].add(lum)
            s_l2 = jnp.zeros(n_pixels, jnp.float32).at[ids].add(lum * lum)

            n_old = counts.astype(jnp.float32)
            n_new = jnp.maximum(n_old + k, 1.0)
            mean_old = luminance(image[:, :3])
            image = image + (s_img - k[:, None] * image) / n_new[:, None]
            albedo = albedo + (s_alb - k[:, None] * albedo) / n_new[:, None]
            normal = normal + (s_nrm - k[:, None] * normal) / n_new[:, None]
            mb = s_l / jnp.maximum(k, 1.0)
            m2b = jnp.maximum(s_l2 - k * mb * mb, 0.0)
            delta = mb - mean_old
            m2 = m2 + m2b + delta * delta * n_old * k / n_new
            counts = counts + k.astype(jnp.int32)
            hit_inc = (valid & (hit | env_case)).astype(jnp.int32)
            hits = hits.at[ids].add(hit_inc)
            return image, albedo, normal, hits, counts, m2

        fn = jax.jit(kernel, donate_argnums=(2, 3, 4, 5, 6, 7))
        self._kernel_cache[key] = fn
        return fn

    # -- driver -----------------------------------------------------------

    def trace_samples(self, state: TraceState) -> TraceState:
        """Advance one batch of samples (src/trace.jl:215-274)."""
        params = self.params
        if state.samples >= params.samples:
            return state
        target = min(state.samples + params.batch, params.samples)
        n = state.n_pixels
        chunk = min(MAX_CHUNK, n)
        if params.adaptive:
            return self._trace_samples_adaptive(state, target, chunk)
        if state.counts is not None:
            raise ValueError(
                "this checkpoint was written by an --adaptive render "
                "(per-pixel counts are heterogeneous); resume with "
                "--adaptive or the uniform running-mean weights would "
                "corrupt converged pixels"
            )
        # multi-sample dispatch (default off): fill lanes with k
        # consecutive samples per call (see _sample_kernel).
        k_env = os.environ.get("JRT_SPP_K")
        k = 1
        if k_env:
            k = max(1, min(int(k_env), target - state.samples))
        # in-dispatch sample loop (see _sample_kernel loop_s): default on
        # for small scenes whose frame fits one chunk, where per-dispatch
        # overhead is a visible share of a sample; bit-identical
        # accumulation. JRT_SPP_LOOP overrides (1 disables).
        loop_s = 1
        if k == 1:
            ls_env = os.environ.get("JRT_SPP_LOOP")
            if ls_env is not None:
                loop_s = max(1, int(ls_env))
            elif self.config.n_prims < 50_000 and n <= chunk:
                loop_s = 8
            loop_s = max(1, min(loop_s, target - state.samples))
        kernel = self._sample_kernel(state.width, state.height, chunk, k,
                                     loop_s)
        image, albedo, normal, hits = state.image, state.albedo, state.normal, state.hits
        # Pad buffers to a chunk multiple so dynamic_update_slice start indices
        # are never clamped (clamping would shift the last partial chunk's
        # writes onto the wrong pixels). The `valid` mask inside the kernel
        # keeps tail lanes at weight 0, and get_image/get_aovs slice back to
        # n_pixels, so the padding is invisible outside this loop.
        n_pad = ((n + chunk - 1) // chunk) * chunk
        if image.shape[0] < n_pad:
            pad = n_pad - image.shape[0]
            image = jnp.pad(image, ((0, pad), (0, 0)))
            albedo = jnp.pad(albedo, ((0, pad), (0, 0)))
            normal = jnp.pad(normal, ((0, pad), (0, 0)))
            hits = jnp.pad(hits, ((0, pad),))
        sample = state.samples
        step = max(k, loop_s)
        while sample < target:
            kk = min(step, target - sample)
            if kk != step:  # tail: smaller batch needs its own compile
                kernel = self._sample_kernel(
                    state.width, state.height, chunk,
                    kk if k > 1 else 1, kk if k == 1 else 1)
            for pixel0 in range(0, n, chunk):
                image, albedo, normal, hits = kernel(
                    self.dscene, self.cam_arrays, image, albedo, normal, hits,
                    jnp.int32(pixel0), jnp.int32(sample),
                )
            sample += kk
        state.image, state.albedo, state.normal, state.hits = image, albedo, normal, hits
        state.samples = target
        return state

    def _trace_samples_adaptive(self, state: TraceState, target: int,
                                chunk: int) -> TraceState:
        """Adaptive-mode batch loop (see _adaptive_kernel): warmup
        batches place samples uniformly while building the variance
        tracker, then each batch's lanes are drawn from it. Buffers stay
        unpadded — accumulation is scatter-based, not slice-based."""
        params = self.params
        n = state.n_pixels
        nchunks = -(-n // chunk)
        if state.counts is None or state.m2 is None:
            raise ValueError(
                "adaptive render needs a state made with "
                "Params(adaptive=True) (or a checkpoint saved from one)"
            )
        bufs = (state.image, state.albedo, state.normal, state.hits,
                state.counts, state.m2)
        for sample in range(state.samples, target):
            uniform = sample < params.adaptive_warmup
            kern = self._adaptive_kernel(state.width, state.height, chunk,
                                         uniform)
            for ci, pixel0 in enumerate(range(0, nchunks * chunk, chunk)):
                bufs = kern(
                    self.dscene, self.cam_arrays, *bufs,
                    jnp.int32(pixel0), jnp.int32(sample * nchunks + ci),
                    jnp.int32(min(chunk, n - pixel0)),
                )
        (state.image, state.albedo, state.normal, state.hits,
         state.counts, state.m2) = bufs
        state.samples = target
        return state

    def get_image(self, state: TraceState) -> np.ndarray:
        """Final [H, W, 4] float image; prefers the denoised buffer when
        present (src/trace.jl:676-690)."""
        src = state.denoised if state.denoised is not None else state.image
        img = np.asarray(jax.block_until_ready(src))
        return img[: state.n_pixels].reshape(state.height, state.width, 4)

    def get_aovs(self, state: TraceState) -> dict[str, np.ndarray]:
        h, w = state.height, state.width
        return {
            "albedo": np.asarray(state.albedo)[: h * w].reshape(h, w, 3),
            "normal": np.asarray(state.normal)[: h * w].reshape(h, w, 3),
            "hits": np.asarray(state.hits)[: h * w].reshape(h, w),
        }
