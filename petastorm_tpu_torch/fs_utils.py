"""Filesystem resolution: dataset URL -> (filesystem, path).

Counterpart of ``petastorm_tpu/fs_utils.py``, cut to local paths and
``file://`` URLs; HDFS and object stores (fsspec) are a later slice.  The
filesystem object exposes the few fsspec-style methods the metadata and
worker code call, over ``os`` and ``open``.
"""

import os
from urllib.parse import urlparse

__all__ = ['LocalFilesystem', 'get_filesystem_and_path']


class LocalFilesystem(object):
    """The local disk, with the fsspec method names the port uses."""

    @staticmethod
    def isfile(path):
        return os.path.isfile(path)

    @staticmethod
    def exists(path):
        return os.path.exists(path)

    @staticmethod
    def makedirs(path, exist_ok=False):
        os.makedirs(path, exist_ok=exist_ok)

    @staticmethod
    def open(path, mode='rb'):
        return open(path, mode)

    @staticmethod
    def find(path):
        """Every file below ``path``, recursively, sorted."""
        found = []
        for root, _, files in os.walk(path):
            found.extend(os.path.join(root, f) for f in files)
        return sorted(found)


def get_filesystem_and_path(url):
    """Resolve a dataset URL (a local path or ``file://`` URL) to
    ``(filesystem, path)``.  The JAX package's list-of-URLs form belongs to
    its batch reader, a later slice."""
    if not isinstance(url, str):
        raise ValueError('dataset_url must be a string, got %r' % (url,))
    parsed = urlparse(url)
    if parsed.scheme not in ('', 'file'):
        raise ValueError('%r: only local paths and file:// URLs are supported in this '
                         'slice of the port; remote filesystems (hdfs, gcs, s3) are a '
                         'later slice' % (url,))
    path = parsed.path if parsed.scheme else url
    return LocalFilesystem(), (path[:-1] if len(path) > 1 and path.endswith('/') else path)
