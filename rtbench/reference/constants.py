"""Shared render constants.

Restatement of the reference's shader-side constant contract (a copy of
raytracevs_tpu/constants.py, kept numpy-free and JAX-free).
The reference keeps these as HLSL ``#define``s in ``src/Shader/Common.hlsli``
(lines 8-100) and parses them back into C++ at pipeline build time
(ShaderCache.h:89, DXRPipeline.cpp:2150-2171) so the two sides can't diverge.
The port's tests hold this copy against the JAX package's, value by value.
"""

# Object type constants (Common.hlsli:8-13)
OBJECT_TYPE_SPHERE = 0
OBJECT_TYPE_PLANE = 1
OBJECT_TYPE_BOX = 2
OBJECT_TYPE_MESH = 3
OBJECT_TYPE_INVALID = 0xFFFFFFFF

# Light type constants (Common.hlsli:16-18)
LIGHT_TYPE_AMBIENT = 0
LIGHT_TYPE_POINT = 1
LIGHT_TYPE_DIRECTIONAL = 2

# Photon mapping (Common.hlsli:23-33)
MAX_PHOTONS = 262144
PHOTON_SEARCH_RADIUS = 0.5
MAX_PHOTON_BOUNCES = 4
CAUSTIC_INTENSITY = 2.0
PHOTON_HASH_TABLE_SIZE = 65536
MAX_PHOTONS_PER_CELL = 64

# Path flags (Common.hlsli:45-48)
PATH_FLAG_INSIDE = 0x1
PATH_FLAG_SPECULAR = 0x2
RAYFLAG_SKIP_SELF = 0x1

# Ray kinds (Common.hlsli:50-53)
RAYKIND_RADIANCE = 0
RAYKIND_SHADOW = 1
RAYKIND_THICKNESS = 2
RAYKIND_PHOTON = 3

# Sky boost multipliers for specular paths (Common.hlsli:61-62)
SKY_BOOST_GLASS = 1.2
SKY_BOOST_METAL = 1.1

# Shadow absorption thickness proxy (Common.hlsli:67)
SHADOW_ABSORPTION_THICKNESS = 1.0

# Checker pattern fade distance (Common.hlsli:73)
CHECKER_FADE_DISTANCE = 50.0

# Photon gather early-out (Common.hlsli:77)
MAX_GATHER_PHOTONS_THRESHOLD = 32

# Per-pixel work queue stride (Common.hlsli:100)
WORK_QUEUE_STRIDE = 8

# Ray budgets (RayGen.hlsl:69-77)
MAX_RAYS_PER_PIXEL = 128
MAX_SPP = 64
MAX_BOUNCES_CLAMP = 32
DEFAULT_MAX_BOUNCES = 8

# Throughput kill threshold (RayGen.hlsl:143)
THROUGHPUT_THRESHOLD = 0.01

# Glass shading constants (RayGen.hlsl:639, 674, 816)
GLASS_TINT_STRENGTH = 0.85
GLASS_ABSORPTION_SCALE = 0.6
METAL_SECONDARY_BOOST = 1.5

# RNG salt channels (Common.hlsli:611-618)
RNG_SALT_AA = 1
RNG_SALT_DOF = 2
RNG_SALT_LIGHT_PICK = 3
RNG_SALT_BRDF = 4
RNG_SALT_RR = 5
RNG_SALT_SHADOW = 6
RNG_SALT_REFLECT = 7
RNG_SALT_REFRACT = 8

# NRD-contract constants (NRDEncoding.hlsli:40-59)
NRD_FP16_MAX = 65504.0
NRD_EPS = 1e-6
SHADOW_FULLY_LIT_THRESHOLD = 0.99
SIGMA_PENUMBRA_ABSOLUTE_MAX = 32768.0
SIGMA_PENUMBRA_PRACTICAL_MAX = 100.0
SIGMA_PENUMBRA_MIN = 0.1
VIEWZ_MIN = 0.01
VIEWZ_SKY = 10000.0
MV_CLAMP_PIXELS = 64.0
MIRROR_BYPASS_ROUGHNESS = 0.05

# Ray t range (RayGen.hlsl:203-206)
RAY_TMIN = 0.001
RAY_TMAX = 10000.0
SELF_OFFSET = 0.002  # child-ray origin offset along normal (RayGen.hlsl:698)
SHADOW_NORMAL_OFFSET = 0.001  # shadow-ray origin offset (Common.hlsli:1214)

PI = 3.14159265359

# Scene capacity caps (RayTraceCompute.hlsl:183-280 brute-force loop caps; we use
# static-shape arrays so these are the padded device-array sizes, not hard limits
# on authored scenes -- flatten.py grows them in powers of two when exceeded).
MAX_SPHERES = 32
MAX_PLANES = 8
MAX_BOXES = 32
MAX_LIGHTS = 8

# Tone map operators (Composite.hlsl:50)
TONEMAP_REINHARD = 0
TONEMAP_ACES = 1
TONEMAP_NONE = 2

GAMMA_SRGB_STANDARD = 2.2
GAMMA_SRGB_TOLERANCE = 0.01
