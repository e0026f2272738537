__version__ = "0.1.0dev"
__author__ = "tpumetrics contributors"
__license__ = "Apache-2.0"
