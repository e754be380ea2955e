"""Parameter conversion between numpy trees and the port's tensor trees."""
