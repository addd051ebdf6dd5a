"""Framework-wide constants (copied from ``hero_tpu/const.py``)."""

VFEAT_DIM = 4352
VCMR_IOU_THDS = (0.5, 0.7)

# max packed subs ("segments") per f-encoder row (data/packing.py)
PACK_MAX_SEGS = 16

# additive mask value for impossible logits / masked attention keys: on a
# fully masked row it cancels in the softmax, so the row stays finite
NEG_INF = -1e4
