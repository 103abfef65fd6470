"""julia_raytracer — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
Princic-1837592/julia-raytracer reference (itself a Julia port of Yocto/GL):
Yocto-style JSON scenes, binary PLY shapes, PNG/HDR textures, a two-tier
BVH flattened for wavefront traversal, the full Yocto BSDF set, naive and
MIS path integrators with homogeneous volumes, and an end-to-end
differentiable render path — all organized as SoA buffers over a flat ray
axis that shards across a device mesh.

Reference parity notes cite the reference's src/*.jl file:line throughout.
"""

__version__ = "0.1.0"
