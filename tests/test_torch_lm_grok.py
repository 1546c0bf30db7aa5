"""The ``grok_1_314b`` smoke model (every layer a top-2 MoE of 8 experts,
attention logits softcapped at 30, GeGLU dense activation, sqrt(d) embedding
scale) served by the port against ``repro.models.model``, on the JAX
package's weights carried across and prompts from a seed; and its full-width
size, which fits on no one card (structure only: defs and counts).

Tolerances: ``F32_ULPS`` f32 ulps of the reference's largest magnitude (3.5
seen on the logits, 3.2 on the caches); bf16 logits no further from JAX's
strict mode than JAX's default mode is (all equal to strict JAX's bit for
bit seen).
"""


from _torch_lm import bf16_mode_gaps, check_f32_serving, strict_fixture
from repro_torch import configs as treg
from repro_torch.models import model as TM

ARCH = "grok_1_314b"
F32_ULPS = 16


def test_f32_serving_matches_reference():
    check_f32_serving(ARCH, F32_ULPS)


def test_full_width_numbers():
    """316.5 B parameters, 633 GB in bf16 (the config's comment in the JAX
    package says 628 GB); 84.6 B active per token (top 2 of 8 experts)."""
    cfg = treg.get_config(ARCH)
    assert TM.n_params(cfg) == 316_489_340_928
    assert TM.n_active_params(cfg) == 84_561_106_944
    assert round(TM.n_params(cfg) * 2 / 1e9) == 633


strict = strict_fixture(ARCH)


def test_bf16_serving_within_jax_precision_mode_gap(strict):
    g = bf16_mode_gaps(ARCH, strict)
    assert g["same"] > 0.99, g
