"""Native (C++) components, built with g++ at first use and bound with
ctypes."""
