"""The image example's worker-side row transform.

A module of its own that imports no ``torch``: under
``reader_pool_type='process'`` each decode process unpickles the transform,
and so imports the module that defines it.
"""

import numpy as np

__all__ = ['FixRow']


class FixRow(object):
    """``fix_row`` of ``examples/imagenet/jax_example.py``: resize the
    decoded image to ``image_hw`` (cv2, bilinear) and turn ``noun_id`` into
    an int32 ``label``, ``hash(noun_id) % 1000``.

    A callable class, not a closure, so that the process pool can pickle
    it.  Like the example's, the label rests on Python's string hash, which
    each interpreter seeds anew unless ``PYTHONHASHSEED`` is set: decode
    processes then give one ``noun_id`` different labels.
    """

    def __init__(self, image_hw):
        self.image_hw = tuple(image_hw)

    def __call__(self, row):
        import cv2
        row = dict(row)
        img = row.pop('image')
        if img.shape[:2] != self.image_hw:
            img = cv2.resize(img, (self.image_hw[1], self.image_hw[0]))
        row['image'] = img
        row['label'] = np.int32(hash(row.pop('noun_id')) % 1000)
        return row
