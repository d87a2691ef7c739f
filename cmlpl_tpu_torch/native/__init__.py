"""The native serving runner (``aoti_host.cpp``) and its launcher."""
