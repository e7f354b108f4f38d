"""The benchmark's yardstick: the manifest and its files, weights and feeds
from the seed, operation and byte counts with the peaks, the traffic
generator, the trace reader and the comparisons that decide ``correct``."""
