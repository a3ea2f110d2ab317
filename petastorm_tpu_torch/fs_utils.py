"""Filesystem resolution: dataset URL -> (filesystem, path).

Counterpart of ``petastorm_tpu/fs_utils.py``, cut to local paths and
``file://`` URLs (one, or a list of them for the batch reader); HDFS and
object stores (fsspec) are a later slice (ROADMAP.md, Queue A item 7, the
storage bullet).  The filesystem object exposes the few fsspec-style
methods the metadata, worker, ingest and converter code call, over ``os``
and ``open``.  A caller may give its own filesystem object, as the
reference's ``filesystem=``: it is used as it is, with the dataset path
taken from the URL.  It needs the methods the port calls: ``open``,
``info``, ``isfile``, ``exists``, ``find``, ``size`` and ``protocol``.
"""

import os
import shutil
from urllib.parse import urlparse

__all__ = ['LocalFilesystem', 'get_filesystem_and_path', 'get_filesystem_and_path_or_paths']


class LocalFilesystem(object):
    """The local disk, with the fsspec method names the port uses."""

    #: fsspec's name of the local protocol: the ingest plane's ``'auto'``
    #: stays off on it
    protocol = 'file'

    @staticmethod
    def size(path):
        return os.path.getsize(path)

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
    def rm(path, recursive=False):
        if os.path.isdir(path):
            if not recursive:
                raise IsADirectoryError(path)
            shutil.rmtree(path)
        else:
            os.remove(path)

    @staticmethod
    def info(path):
        """fsspec's local ``info`` keys the cache plane's fingerprint reads."""
        st = os.stat(path)
        return {'name': path, 'size': st.st_size, 'mtime': st.st_mtime,
                'type': 'directory' if os.path.isdir(path) else 'file'}

    @staticmethod
    def find(path):
        """Every file below ``path``, recursively, sorted."""
        found = []
        for root, _, files in os.walk(path):
            found.extend(os.path.join(root, f) for f in files)
        return sorted(found)


def get_filesystem_and_path(url, filesystem=None):
    """Resolve a dataset URL (a local path or ``file://`` URL) to
    ``(filesystem, path)``; a ``filesystem`` given is returned as it is,
    beside the URL's path."""
    if not isinstance(url, str):
        raise ValueError('dataset_url must be a string, got %r' % (url,))
    parsed = urlparse(url)
    if filesystem is not None:
        path = parsed.path if parsed.scheme else url
        return filesystem, (path[:-1] if len(path) > 1 and path.endswith('/') else path)
    if parsed.scheme not in ('', 'file'):
        raise ValueError('%r: only local paths and file:// URLs are supported in this '
                         'slice of the port; remote filesystems (hdfs, gcs, s3) are a '
                         'later slice (ROADMAP.md, Queue A item 7, the storage bullet)'
                         % (url,))
    path = parsed.path if parsed.scheme else url
    return LocalFilesystem(), (path[:-1] if len(path) > 1 and path.endswith('/') else path)


def get_filesystem_and_path_or_paths(url_or_urls, filesystem=None):
    """Resolve one URL, or a list of URLs on one filesystem, to
    ``(filesystem, path)`` or ``(filesystem, [paths])``; URLs of mixed
    schemes raise.  A ``filesystem`` given serves every URL."""
    urls = url_or_urls if isinstance(url_or_urls, list) else [url_or_urls]
    if not urls:
        raise ValueError('dataset_url_or_urls is an empty list')
    schemes = {urlparse(u).scheme or 'file' for u in urls if isinstance(u, str)}
    if len(schemes) > 1:
        raise ValueError('All dataset URLs must share a scheme, got %s' % sorted(schemes))
    resolved = [get_filesystem_and_path(u, filesystem) for u in urls]
    paths = [path for _, path in resolved]
    return resolved[0][0], (paths if isinstance(url_or_urls, list) else paths[0])
