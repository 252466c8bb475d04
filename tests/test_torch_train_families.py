"""The port's training loss and gradients against the reference's, for
the reduced ssm (rwkv6-3b: 2 layers, chunk 16), hybrid (jamba: 2 periods
of 7 Mamba layers and 1 attention layer, MoE of 4 experts top-2 on every
second layer) and vision (llama-3.2-vision-90b: 2 periods of 4
self-attention and 1 cross-attention layers over 16 image tokens, the
xattn gates drawn nonzero) families: `test_torch_train_models.py`'s
check (float32, seq 128, batch 2; loss within rel 1e-5, every gradient
within 1e-4 of its leaf's max, remat and no remat bitwise equal) in a
file of its own, so that the two files' reference compilations run on
two test workers. The port trains on `wkv_chunked` and `selective_scan`
(the reference's routes with `use_pallas` off); observed: loss rel <=
1.6e-7, gradients <= 1.7e-5 of the leaf's max (jamba's dt_proj).
"""
import pytest

from _torch_threads import one_thread  # noqa: F401
from test_torch_train_models import check_family

pytest.importorskip("jax")


@pytest.mark.parametrize("arch", ["rwkv6_3b", "jamba_v0_1_52b",
                                  "llama3_2_vision_90b"])
def test_loss_and_gradients_match_reference(arch):
    check_family(arch)
