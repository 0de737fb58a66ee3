"""Build hooks: compiles the native streaming runtime (native/ringbuf.cc —
the role GNU Radio's C++ scheduler/ring buffers play in the reference,
SURVEY.md §2.8 X1-X2) as a C-ABI shared object shipped inside the package.

`runtime/native.py` loads this extension first and falls back to an ad-hoc
g++ build from the source tree for editable/dev checkouts.
"""

from setuptools import Extension, setup

setup(
    ext_modules=[
        Extension(
            "lte_gnu_radio_code._ringbuf",
            sources=["native/ringbuf.cc"],
            extra_compile_args=["-O3", "-std=c++17"],
            extra_link_args=["-lpthread"],
            language="c++",
        )
    ],
)
