"""Synthetic VOC-style detection dataset written as RecordIO, over the
PyTorch port (the twin of ``dataset.py``).

Images contain 1-3 solid rectangles; the class IS the color, so a
detector that converges has genuinely learned localization +
classification. With the default three classes the color is the class's
channel and every draw is ``dataset.py``'s; more classes (VOC's 20) take
further colors from a fixed palette.
Records use the reference's detection label layout
([header_width, obj_width, objects...], tools/im2rec detection lists) and
the standard IRHeader wire format, so reference tooling can read them back.
"""
import itertools
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from mxnet_tpu_torch import recordio as rio  # noqa: E402

NUM_CLASSES = 3  # red / green / blue rectangles


def _palette():
    """Class colors: the three pure channels first (``dataset.py``'s),
    then the other mixes of 40, 130 and 220, none of them the 32 gray of
    the background."""
    pure = [tuple(220 if c == k else 40 for c in range(3)) for k in range(3)]
    rest = [c for c in itertools.product((40, 130, 220), repeat=3)
            if c not in pure and c != (40, 40, 40)]
    return np.array(pure + rest, np.uint8)


PALETTE = _palette()


def make_image(rng, size=64, max_objs=3, num_classes=NUM_CLASSES):
    img = np.full((size, size, 3), 32, np.uint8)
    n = rng.randint(1, max_objs + 1)
    objs = []
    for _ in range(n):
        cls = rng.randint(num_classes)
        w = rng.randint(size // 5, size // 2)
        h = rng.randint(size // 5, size // 2)
        x1 = rng.randint(0, size - w)
        y1 = rng.randint(0, size - h)
        img[y1:y1 + h, x1:x1 + w] = PALETTE[cls]
        objs.append((cls, x1 / size, y1 / size, (x1 + w) / size,
                     (y1 + h) / size))
    return img, objs


def write_records(prefix, num_images=128, size=64, seed=7,
                  num_classes=NUM_CLASSES, max_objs=3):
    """Write <prefix>.rec/.idx/.lst; returns the .rec path."""
    rng = np.random.RandomState(seed)
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    with open(prefix + ".lst", "w") as lst:
        for i in range(num_images):
            img, objs = make_image(rng, size, max_objs, num_classes)
            label = [2.0, 5.0]          # header_width, obj_width
            for o in objs:
                label.extend(o)
            header = rio.IRHeader(0, np.asarray(label, "float32"), i, 0)
            rec.write_idx(i, rio.pack_img(header, img, quality=95))
            lst.write(f"{i}\t" + "\t".join(f"{v:.4f}" for v in label)
                      + f"\tsynthetic_{i}.jpg\n")
    rec.close()
    return prefix + ".rec"


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "ssd_synth/train"
    os.makedirs(os.path.dirname(out), exist_ok=True)
    print(write_records(out))
