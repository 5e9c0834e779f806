"""Native (C++/OpenMP) host kernels of the data path, built at first use
(``kittiops.library``)."""
