"""The C++ input feed (``--native_loader``), built with g++ at first use."""
